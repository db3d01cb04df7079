"""The port's k-means and codebook restarts against the JAX package on the CPU.

JAX's PRNG streams cannot be reproduced in torch, so the random parts are
fed to both sides where they are inputs, and held by properties where they
are not:
- exact: one Lloyd update from given centroids and given reseed indices
  equals the JAX update (the centroids the JAX `kmeans` starts from and its
  first iteration's reseed indices are read off its own key); the dead-code
  restart with given reseed indices equals JAX's `restart_dead_codebook_entries`;
- properties: k-means++ centroids are data points, the returned assignment
  is the argmin to the centroids it was computed from, a converged run's to
  the final ones, empty clusters are reseeded, dead codes are revived and
  used codes are untouched (tests/test_codebook_restart.py on the port), and
  a generator's seed repeats a run bit for bit.
Tolerances: centroids atol = rtol = 1e-6 (means of the same points summed in
another order); assignments, counts and reseeded codewords exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.models.quantize import QuantizeForwardMode as JMode
from rqvae_tpu.models.rqvae import RqVae as JRqVae
from rqvae_tpu.models.rqvae import RqVaeConfig as JRqVaeConfig
from rqvae_tpu.models.rqvae import restart_dead_codebook_entries as j_restart
from rqvae_tpu.ops.kmeans import kmeans as j_kmeans

from rqvae_tpu_torch.models.quantize import QuantizeForwardMode
from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig, restart_dead_codebook_entries
from rqvae_tpu_torch.ops.kmeans import kmeans, kmeanspp_init, lloyd_update, pairwise_sq_dists
from rqvae_tpu_torch.utils.convert import load_jax_params


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(n=200, d=6, seed=0, dup=0):
    """Clustered points; with dup > 0 the first dup rows repeated at the end,
    so that two random initial centroids can coincide (an empty cluster)."""
    r = np.random.RandomState(seed)
    x = (r.randn(5, d)[r.randint(0, 5, n)] * 3 + r.randn(n, d)).astype(np.float32)
    if dup:
        x = np.concatenate([x, np.repeat(x[:1], dup, axis=0)])
    return x


@pytest.mark.parametrize("init,k,dup", [("random", 16, 60), ("kmeans++", 12, 0), ("random", 7, 0)])
def test_one_lloyd_update_equals_jax(init, k, dup):
    x = _points(dup=dup)
    key = jax.random.PRNGKey(3)
    c0 = np.asarray(j_kmeans(key, jnp.asarray(x), k=k, max_iters=0, init=init).centroids)
    one = j_kmeans(key, jnp.asarray(x), k=k, max_iters=1, init=init)
    _, loop_key = jax.random.split(key)
    reseed = np.asarray(jax.random.randint(jax.random.fold_in(loop_key, 0), (k,), 0, x.shape[0]))
    new_c, a = lloyd_update(torch.from_numpy(x), torch.from_numpy(c0), torch.from_numpy(reseed).long())
    np.testing.assert_array_equal(a.numpy(), np.asarray(one.assignment))
    np.testing.assert_allclose(new_c.numpy(), np.asarray(one.centroids), atol=1e-6, rtol=1e-6)
    counts = np.bincount(a.numpy(), minlength=k)
    if dup:  # the case exercises the reseed of an empty cluster
        assert (counts == 0).any()
        np.testing.assert_array_equal(new_c.numpy()[counts == 0], x[reseed][counts == 0])


def test_kmeanspp_centroids_are_data_points_and_spread():
    x = torch.from_numpy(_points(n=300, seed=1))
    c = kmeanspp_init(x, 20, torch.Generator().manual_seed(0))
    d = pairwise_sq_dists(c.double(), x.double())
    assert (d.min(1).values < 1e-9).all()  # every centroid is a data point
    assert len({tuple(v) for v in c.numpy().tolist()}) == 20  # D^2 sampling never repeats a point here


def test_kmeans_properties_and_repeatability():
    x = torch.from_numpy(_points(n=300, seed=2))
    out = kmeans(x, 8, torch.Generator().manual_seed(1), max_iters=100)
    assert out.iterations < 100  # converged: the assignment is also the final centroids' argmin
    assert torch.equal(out.assignment, torch.argmin(pairwise_sq_dists(x, out.centroids), dim=-1))
    for j in range(8):  # each centroid is the mean of its points
        pts = x[out.assignment == j]
        if len(pts):
            np.testing.assert_allclose(out.centroids[j].numpy(), pts.mean(0).numpy(), atol=1e-5)
    again = kmeans(x, 8, torch.Generator().manual_seed(1), max_iters=100)
    assert torch.equal(again.centroids, out.centroids) and again.iterations == out.iterations
    cut = kmeans(x, 8, torch.Generator().manual_seed(1), max_iters=2)
    assert cut.iterations == 2
    with pytest.raises(ValueError):
        kmeans(x, 8, torch.Generator(), init="farthest")


def test_kmeans_lowers_inertia_like_jax():
    """Different streams, the same algorithm: both reach a similar inertia."""
    x = _points(n=400, seed=4)
    j = j_kmeans(jax.random.PRNGKey(0), jnp.asarray(x), k=10)
    t = kmeans(torch.from_numpy(x), 10, torch.Generator().manual_seed(0))
    inertia = lambda c, a: float(((x - np.asarray(c)[np.asarray(a)]) ** 2).sum())
    ji, ti = inertia(j.centroids, j.assignment), inertia(t.centroids.numpy(), t.assignment.numpy())
    assert ti <= 1.25 * ji and ji <= 1.25 * ti, (ti, ji)


CFG = dict(input_dim=16, embed_dim=8, hidden_dims=(16,), codebook_size=32, n_layers=2, n_cat_feats=0)


def _restart_setup():
    """tests/test_codebook_restart.py's setup: most codewords moved far from
    the data, so that they are dead."""
    jm = JRqVae(JRqVaeConfig(**CFG, codebook_mode=JMode.STE))
    x = np.random.RandomState(0).randn(128, 16).astype(np.float32)
    params = jax.device_get(jm.init({"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)},
                                    jnp.asarray(x), 0.2, training=True))
    cbs = np.asarray(params["params"]["codebooks"]).copy()
    cbs[:, 4:, :] = 1000.0
    params["params"]["codebooks"] = cbs
    tm = load_jax_params(RqVae(RqVaeConfig(**CFG, codebook_mode=QuantizeForwardMode.STE), device="cpu"), params)
    return jm, params, tm, x


def test_restart_with_given_indices_equals_jax():
    jm, params, tm, x = _restart_setup()
    key = jax.random.PRNGKey(2)
    new_params, dead = j_restart(key, jm, params, jnp.asarray(x))
    idx = np.stack([np.asarray(jax.random.randint(jax.random.fold_in(key, level), (32,), 0, 128))
                    for level in range(2)])
    got = restart_dead_codebook_entries(tm, torch.from_numpy(x), reseed_idx=torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(dead))
    np.testing.assert_allclose(tm.codebooks.detach().numpy(), np.asarray(new_params["params"]["codebooks"]),
                               atol=1e-6, rtol=1e-6)


def test_restart_revives_dead_codes():
    _, _, tm, x = _restart_setup()
    x = torch.from_numpy(x)
    out0 = tm.get_semantic_ids(x)
    usage0 = np.array([len(np.unique(out0.sem_ids[:, l].numpy())) for l in range(2)])
    assert (usage0 <= 4).all()
    dead = restart_dead_codebook_entries(tm, x, torch.Generator().manual_seed(2))
    assert (dead.numpy() >= 28).all()
    out1 = tm.get_semantic_ids(x)
    usage1 = np.array([len(np.unique(out1.sem_ids[:, l].numpy())) for l in range(2)])
    assert (usage1 > usage0).all(), f"{usage0} -> {usage1}"
    assert out1.quantize_loss.mean().item() < out0.quantize_loss.mean().item()


def test_restart_leaves_used_codes_untouched():
    _, _, tm, x = _restart_setup()
    x = torch.from_numpy(x)
    used0 = np.unique(tm.get_semantic_ids(x).sem_ids[:, 0].numpy())
    old = tm.codebooks.detach().clone()
    restart_dead_codebook_entries(tm, x, torch.Generator().manual_seed(3))
    assert torch.equal(tm.codebooks.detach()[0, used0], old[0, used0])
    assert not torch.equal(tm.codebooks.detach(), old)
