"""PyTorch/CUDA port of rqvae_tpu: generative semantic-ID retrieval.

The serving path (corpus index build -> constrained beam search) and stage-2
(retrieval) training run on an NVIDIA Hopper card, with hand-written CUDA C++
kernels (csrc/) in place of the JAX package's Pallas TPU kernels. Entry
points (`Retriever`, `Retriever.from_checkpoints`, `RetrievalEngine`,
`AsyncRetrievalEngine`, `SemanticIdTokenizer`, the model constructors,
`train.train_decoder.train`, `train.train_rqvae.train`) run on the card
unless the caller passes `device="cpu"`; they raise when no card is present.
The serving engine runs each (batch, items) bucket as one CUDA graph.
"""
