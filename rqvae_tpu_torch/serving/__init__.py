"""Serving layer: corpus trie, retriever, bucketed engine, async queue (the
exports of rqvae_tpu/serving/__init__.py).

Exports resolve lazily: models/retrieval.py imports
rqvae_tpu_torch.serving.beam, so eager re-exports of the retriever and the
engine here would close an import cycle through the model package.
"""

_EXPORTS = {
    "PrefixTable": "rqvae_tpu_torch.serving.beam",
    "build_prefix_table": "rqvae_tpu_torch.serving.beam",
    "extend_prefix_table": "rqvae_tpu_torch.serving.beam",
    "RetrievalEngine": "rqvae_tpu_torch.serving.engine",
    "AsyncRetrievalEngine": "rqvae_tpu_torch.serving.queue",
    "RetrievalResult": "rqvae_tpu_torch.serving.retriever",
    "Retriever": "rqvae_tpu_torch.serving.retriever",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
