"""The benchmark imports nothing of JAX or the JAX package, and its
reference imports nothing of the program either."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]  # perfbench/
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "rqvae_tpu"}


def _imported_tops(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


MODULES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=[str(p.relative_to(HERE)) for p in MODULES])
def test_no_jax_anywhere(path):
    found = set(_imported_tops(path)) & BANNED
    assert not found, f"{path.relative_to(HERE)} imports {sorted(found)}"


REFERENCE = sorted((HERE / "reference").rglob("*.py"))


@pytest.mark.parametrize("path", REFERENCE, ids=[p.name for p in REFERENCE])
def test_reference_imports_nothing_of_the_program(path):
    tops = set(_imported_tops(path))
    assert "rqvae_tpu_torch" not in tops, f"reference/{path.name} imports the program"
    assert not tops & BANNED


def test_whole_names_are_compared():
    """rqvae_tpu_torch is not rqvae_tpu: the check compares whole top-level names."""
    import sys

    from perfbench.harness import env

    assert "rqvae_tpu_torch" not in env.BANNED
    before = dict(sys.modules)
    try:
        sys.modules["rqvae_tpu_torch_fake.sub"] = object()
        sys.modules["jaxish"] = object()
        assert env.banned_loaded() == sorted({m.split(".")[0] for m in before} & env.BANNED)
        sys.modules["jax.numpy"] = object()
        assert "jax" in env.banned_loaded()
    finally:
        for k in ("rqvae_tpu_torch_fake.sub", "jaxish", "jax.numpy"):
            sys.modules.pop(k, None)
