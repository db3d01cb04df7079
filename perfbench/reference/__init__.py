"""The benchmark's plain reference: generative retrieval over semantic ids in
plain PyTorch, float32 with TF32 off, written from the published description
(TIGER, arXiv:2305.05065; T5 as in the RQ-VAE-Recommender project) and
independent of the measured package. It imports nothing of the program.

- `hashing`: a frozen copy of the counter-hash dropout keep bits.
- `precision`: the products at float32 or at the control's fp8 (e4m3).
- `rqvae`: MLP encode, residual quantization, the dedup column.
- `t5`: the encoder-decoder, its teacher-forced loss and its inference.
- `train`: windows, tokenization, the training loss, AdamW.
- `beam`: constrained beam search and the inverse lookup.
"""
