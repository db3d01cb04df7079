"""The JAX package's optimizer state (optax, as flax writes it into a
checkpoint) read and written by the port (train/state.py::optax_state,
load_optax_state; utils/checkpoint.py), on the CPU.

- In each layout the JAX trainers build (a constant LR or the schedule,
  clipping or none), the port's tree restores into `tx.init(params)` with
  `flax.serialization.from_state_dict`, every leaf bit-equal, and the port
  writes it to the same bytes as `flax.serialization.msgpack_serialize`
  (optax's EmptyState as an empty map, which the port's reader keeps).
- A JAX state after 3 optax updates loads into the port's AdamW bit-equal,
  with the LR position of the schedule at that count.
- One update from a JAX state after 3 steps, in the port, against optax's
  update (f32 tolerance), and the reverse.
- A tree that does not fit the optimizer's settings, or whose counts
  differ, raises; `export_jax_checkpoint` rewrites a port `.pt` as a file
  the JAX package restores with its templates.

The trainers resuming across the packages are in
tests/test_torch_decoder_trainer.py and tests/test_torch_rqvae_trainer.py.
"""

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rqvae_tpu.ops import schedules as jsched
from rqvae_tpu.train import state as jstate
from rqvae_tpu.utils import checkpoint as jckpt

from rqvae_tpu_torch.models import retrieval as tr
from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
from rqvae_tpu_torch.ops import schedules as tsched
from rqvae_tpu_torch.train.state import adamw, load_optax_state, optax_state
from rqvae_tpu_torch.utils import checkpoint as tckpt
from rqvae_tpu_torch.utils import flax_msgpack
from rqvae_tpu_torch.utils.convert import grads_from_jax, jax_params_from_state_dict

DEC = dict(num_hierarchies=3, codebook_size=16, t5_d_model=32, t5_d_kv=8, t5_num_heads=4, t5_d_ff=64,
           t5_num_layers=1, top_k_for_generation=5, num_user_bins=5)
RQ = dict(input_dim=64, embed_dim=8, hidden_dims=(32,), codebook_size=16, n_layers=3, n_cat_feats=0,
          codebook_mode=QuantizeForwardMode.STE)
# (name, schedule, max_grad_norm): stage 1's constant LR; stage 2's schedule, clipped or not
LAYOUTS = [("constant", False, None), ("schedule", True, None), ("schedule_clip", True, 0.5),
           ("constant_clip", False, 0.5)]
WARMUP = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(which="decoder"):
    if which == "rqvae":
        return RqVae(RqVaeConfig(**RQ), device="cpu", seed=1)
    return tr.EncoderDecoderRetrievalModel(tr.RetrievalConfig(**DEC), device="cpu", seed=1)


def _port_opt(model, schedule, clip):
    lr = tsched.inverse_sqrt_schedule(1e-3, WARMUP) if schedule else 1e-3
    return adamw(model.parameters(), lr, weight_decay=0.1, max_grad_norm=clip)


def _jax_tx(schedule, clip):
    lr = jsched.inverse_sqrt_schedule(1e-3, WARMUP) if schedule else 1e-3
    return jstate.adamw(lr, weight_decay=0.1, max_grad_norm=clip)


def _jax_params(model):
    return jax.tree_util.tree_map(jnp.asarray, jax_params_from_state_dict(model))


def _adam(state, clip):
    """optax's ScaleByAdamState of a JAX state (inside the clip's chain)."""
    inner = state[1] if clip is not None else state
    return inner[0]


def _assert_moments_equal(opt, model, adam_state):
    names = [n for n, _ in model.named_parameters()]
    for key, ours in (("mu", opt.mu), ("nu", opt.nu)):
        theirs = grads_from_jax(jax.device_get(getattr(adam_state, key)))
        assert set(theirs) == set(names)
        for name, m in zip(names, ours):
            assert torch.equal(m, theirs[name]), (key, name)


def _random_moments(opt, count, seed=0):
    g = torch.Generator().manual_seed(seed)
    for m in opt.mu:
        m.copy_(torch.randn(m.shape, generator=g))
    for v in opt.nu:
        v.copy_(torch.rand(v.shape, generator=g))
    opt.step_count.fill_(count)


@pytest.mark.parametrize("which", ["decoder", "rqvae"])
@pytest.mark.parametrize("name,schedule,clip", LAYOUTS)
def test_port_tree_restores_into_the_optax_template(name, schedule, clip, which):
    model = _model(which)
    opt = _port_opt(model, schedule, clip)
    _random_moments(opt, 5)
    tree = optax_state(opt, model)
    template = _jax_tx(schedule, clip).init(_jax_params(model))
    restored = fser.from_state_dict(template, tree)
    adam = _adam(restored, clip)
    assert int(adam.count) == 5 and np.asarray(adam.count).dtype == np.int32
    _assert_moments_equal(opt, model, adam)
    if schedule:
        sched = (restored[1] if clip is not None else restored)[2]
        assert int(sched.count) == 5 and np.asarray(sched.count).dtype == np.int32
    blob = flax_msgpack.msgpack_serialize(tree)
    assert blob == fser.msgpack_serialize(fser.to_state_dict(restored))
    back = flax_msgpack.msgpack_restore(blob)
    inner = back["1"] if clip is not None else back
    assert inner["1"] == {} and (back["0"] == {} if clip is not None else True)
    assert fser.msgpack_restore(blob).keys() == back.keys()


@pytest.mark.parametrize("name,schedule,clip", LAYOUTS)
def test_jax_state_after_three_updates_loads_bit_equal(name, schedule, clip):
    model = _model()
    tx = _jax_tx(schedule, clip)
    params = _jax_params(model)
    state = tx.init(params)
    rng = np.random.RandomState(3)
    for _ in range(3):
        grads = jax.tree_util.tree_map(lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32)), params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    tree = jax.device_get(fser.to_state_dict(state))
    tree = flax_msgpack.msgpack_restore(fser.msgpack_serialize(tree))  # as a checkpoint holds it
    opt = _port_opt(model, schedule, clip)
    load_optax_state(opt, model, tree)
    assert opt.count == 3
    _assert_moments_equal(opt, model, _adam(state, clip))
    if schedule:
        assert opt.lr() == pytest.approx(float(jsched.inverse_sqrt_schedule(1e-3, WARMUP)(3)), rel=1e-6)


def _one_optax_update(tx, params, state, grads):
    updates, state = tx.update(grads, state, params)
    return optax.apply_updates(params, updates), state


@pytest.mark.parametrize("name,schedule,clip", LAYOUTS)
def test_one_update_from_the_other_packages_state(name, schedule, clip):
    """JAX -> port: a JAX state after 3 steps loaded into the port, one
    port update against one optax update; port -> JAX: a port state after
    3 steps restored into the optax template, the same. Parameters within
    atol 1e-6 (a few f32 steps of updates ~1e-3), moments within 1e-6."""
    rng = np.random.RandomState(5)
    model = _model()
    tx = _jax_tx(schedule, clip)
    names = [n for n, _ in model.named_parameters()]
    grad_trees = [jax.tree_util.tree_map(lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32)),
                                         _jax_params(model)) for _ in range(4)]

    def port_grads(opt, tree):
        by_name = grads_from_jax(jax.device_get(tree))
        for n, p in zip(names, opt.params):
            p.grad = by_name[n].clone()

    # JAX -> port
    params, state = _jax_params(model), tx.init(_jax_params(model))
    for g in grad_trees[:3]:
        params, state = _one_optax_update(tx, params, state, g)
    port = _model()
    port.load_state_dict(grads_from_jax(jax.device_get(params)))
    opt = _port_opt(port, schedule, clip)
    load_optax_state(opt, port, jax.device_get(fser.to_state_dict(state)))
    port_grads(opt, grad_trees[3])
    opt.step()
    params, state = _one_optax_update(tx, params, state, grad_trees[3])
    want = grads_from_jax(jax.device_get(params))
    for n, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), atol=1e-6, rtol=0, err_msg=n)

    # port -> JAX
    port = _model()
    opt = _port_opt(port, schedule, clip)
    for g in grad_trees[:3]:
        port_grads(opt, g)
        opt.step()
    params = _jax_params(port)
    state = fser.from_state_dict(tx.init(params), optax_state(opt, port))
    params, state = _one_optax_update(tx, params, state, grad_trees[3])
    port_grads(opt, grad_trees[3])
    opt.step()
    want = grads_from_jax(jax.device_get(params))
    for n, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), atol=1e-6, rtol=0, err_msg=n)
    adam = _adam(state, clip)
    assert int(adam.count) == opt.count == 4
    for key, ours in (("mu", opt.mu), ("nu", opt.nu)):
        theirs = grads_from_jax(jax.device_get(getattr(adam, key)))
        for n, m in zip(names, ours):
            np.testing.assert_allclose(m.numpy(), theirs[n].numpy(), atol=1e-6, rtol=1e-5, err_msg=n)


def test_a_tree_that_does_not_fit_the_optimizer_raises():
    model = _model()
    opt = _port_opt(model, True, None)
    tree = optax_state(opt, model)
    for schedule, clip in ((False, None), (True, 0.5), (False, 0.5)):
        with pytest.raises(ValueError, match="opt_state"):
            load_optax_state(_port_opt(model, schedule, clip), model, tree)
    tree["2"]["count"] = np.asarray(7, np.int32)
    with pytest.raises(ValueError, match="counts? .*differ"):
        load_optax_state(opt, model, tree)
    tree = optax_state(opt, model)
    del tree["0"]["mu"]["params"]["heads"]
    with pytest.raises(ValueError, match="heads"):
        load_optax_state(opt, model, tree)
    with pytest.raises(ValueError, match="not parameters of the model"):
        optax_state(opt, _model())


@pytest.mark.parametrize("which", ["decoder", "rqvae"])
def test_export_jax_checkpoint_restores_in_the_jax_package(tmp_path, which):
    """A port `.pt` training checkpoint rewritten as the JAX file: the JAX
    package's load_checkpoint restores params and opt_state into the
    templates of the trainer of its stage (stage 2 clipped here)."""
    model = _model(which)
    schedule, clip = (True, 0.5) if which == "decoder" else (False, None)
    opt = _port_opt(model, schedule, clip)
    _random_moments(opt, 9, seed=2)
    src = tckpt.save_checkpoint(str(tmp_path / "pt"), 8, model.state_dict(), opt.state_dict(), model.config)
    dst = tckpt.export_jax_checkpoint(src, str(tmp_path / "jax"), max_grad_norm=clip)
    assert dst.endswith("checkpoint_8.msgpack")
    params = _jax_params(model)
    got = jckpt.load_checkpoint(dst, params_template=params, opt_state_template=_jax_tx(schedule, clip).init(params))
    assert got["step"] == 8 and int(_adam(got["opt_state"], clip).count) == 9
    _assert_moments_equal(opt, model, _adam(got["opt_state"], clip))
    restored = grads_from_jax(jax.device_get(got["params"]))
    for n, p in model.named_parameters():
        assert torch.equal(restored[n], p.detach()), n
    # and the port resumes from it as from the .pt
    again = _model(which)
    opt2 = _port_opt(again, schedule, clip)
    assert tckpt.restore_training_state(tckpt.load_checkpoint(dst), again, opt2) == 9
    _assert_moments_equal(opt2, again, _adam(got["opt_state"], clip))
    with pytest.raises(ValueError, match="JAX-format"):
        tckpt.export_jax_checkpoint(dst, str(tmp_path / "again"))
