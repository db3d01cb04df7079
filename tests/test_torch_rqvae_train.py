"""The port's stage-1 training path against the JAX package on the CPU: losses,
the three quantizer estimators, the RQ-VAE training forward and every
gradient, the train / eval steps with AdamW, and the cases of
tests/test_rqvae.py (TestQuantizeForward, TestRqVae) and
tests/test_quantize_variants.py (TestRotationKmeansInitParity,
TestGumbelTraining) on the port.

Same inputs (numpy, seeded), same weights (JAX params through
utils/convert.py). Gumbel noise: the JAX model's own draws, recorded as its
`gumbel_softmax_sample` makes them, and handed to the port. Tolerances:
loss within rtol 1e-5 and each gradient within 2e-4 of its largest entry
(the training gate's measure); elementwise values atol = rtol = 1e-5;
ids exact (the seeds keep every row away from an argmin near-tie, asserted).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rqvae_tpu.models.quantize as jq
from rqvae_tpu.models.rqvae import RqVae as JRqVae
from rqvae_tpu.models.rqvae import RqVaeConfig as JRqVaeConfig
from rqvae_tpu.ops import dedup as jdedup
from rqvae_tpu.ops import losses as jlosses
from rqvae_tpu.ops.gumbel import sample_gumbel as j_sample_gumbel
from rqvae_tpu.train import rqvae_steps as jsteps
from rqvae_tpu.train import state as jstate

from rqvae_tpu_torch.models import quantize as tq
from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig, kmeans_init_codebooks
from rqvae_tpu_torch.ops import dedup as tdedup
from rqvae_tpu_torch.ops import gumbel as tgumbel
from rqvae_tpu_torch.ops import losses as tlosses
from rqvae_tpu_torch.train import rqvae_steps as tsteps
from rqvae_tpu_torch.train.state import adamw
from rqvae_tpu_torch.utils.convert import grads_from_jax, load_jax_params

TOL = dict(atol=1e-5, rtol=1e-5)
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4  # of the gradient tensor's largest entry
MODES = {"STE": (jq.QuantizeForwardMode.STE, tq.QuantizeForwardMode.STE),
         "ROTATION_TRICK": (jq.QuantizeForwardMode.ROTATION_TRICK, tq.QuantizeForwardMode.ROTATION_TRICK),
         "GUMBEL_SOFTMAX": (jq.QuantizeForwardMode.GUMBEL_SOFTMAX, tq.QuantizeForwardMode.GUMBEL_SOFTMAX)}
FIELDS = dict(input_dim=24, embed_dim=8, hidden_dims=(16, 12), codebook_size=16, n_layers=3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _data(n, input_dim, seed, n_cat=0):
    """Clustered rows; the trailing n_cat columns binary (the categorical features)."""
    r = np.random.RandomState(seed)
    centers = r.randn(6, input_dim) * 2
    x = (centers[r.randint(0, 6, n)] + 0.3 * r.randn(n, input_dim)).astype(np.float32)
    if n_cat:
        x[:, -n_cat:] = (r.rand(n, n_cat) < 0.3).astype(np.float32)
    return x


def _models(mode="STE", seed=0, n=64, kmeans=True, **over):
    """(jax model, params as numpy, port model, x): k-means codebooks,
    jittered (exact centroids have a codebook gradient of rounding noise, and
    a reseeded cluster can duplicate a codeword, which ties argmins), so the
    quantizers see realistic assignments; no row at an argmin near-tie."""
    fields = {**FIELDS, **over}
    jmode, tmode = MODES[mode]
    jm = JRqVae(JRqVaeConfig(**fields, codebook_mode=jmode))
    x = _data(n, fields["input_dim"], seed, fields.get("n_cat_feats", 0))
    params = jm.init({"params": jax.random.PRNGKey(seed), "gumbel": jax.random.PRNGKey(seed + 1)},
                     jnp.asarray(x[:8]), 0.2, training=True)
    if kmeans:
        from rqvae_tpu.models.rqvae import kmeans_init_codebooks as j_kmeans_init

        params = j_kmeans_init(jax.random.PRNGKey(seed + 2), jm, params, jnp.asarray(x), max_iters=20)
    params = jax.device_get(params)
    if kmeans:
        cb = np.asarray(params["params"]["codebooks"])
        params["params"]["codebooks"] = cb + 0.1 * cb.std() * np.random.RandomState(seed + 3).randn(*cb.shape).astype(np.float32)
    ev = jm.apply(params, jnp.asarray(x), training=False, method=JRqVae.get_semantic_ids)
    assert _min_gap(np.asarray(ev.residuals), np.asarray(params["params"]["codebooks"])) > 1e-5
    tm = load_jax_params(RqVae(RqVaeConfig(**fields, codebook_mode=tmode), device="cpu"), params)
    return jm, params, tm, x


def _min_gap(residuals, codebooks):
    """Smallest top-2 L2 distance gap over rows and levels, in float64,
    relative to ||r||^2 + max ||c||^2 (f32 rounding moves a distance by ~1e-7 of that)."""
    gaps = []
    for level in range(codebooks.shape[0]):
        r, c = residuals[:, level].astype(np.float64), codebooks[level].astype(np.float64)
        top2 = np.sort(((r[:, None, :] - c[None]) ** 2).sum(-1), axis=1)[:, :2]
        gaps.append((top2[:, 1] - top2[:, 0]) / ((r * r).sum(-1) + (c * c).sum(-1).max()))
    return float(np.min(gaps))


class _RecordJaxNoise:
    """Wraps the JAX quantizer's gumbel_softmax_sample: the same draws, the
    same value, and each level's noise kept for the port."""

    def __init__(self, monkeypatch):
        self.noise = []
        monkeypatch.setattr(jq, "gumbel_softmax_sample", self)

    def __call__(self, key, logits, temperature):
        g = j_sample_gumbel(key, logits.shape, dtype=logits.dtype)
        self.noise.append(np.array(g))
        return jax.nn.softmax((logits + g) / temperature, axis=-1)

    def torch_noise(self):
        return [torch.from_numpy(g) for g in self.noise]


def _jax_loss_grads(jm, params, x, t, key=3):
    def f(p):
        out = jm.apply(p, jnp.asarray(x), t, training=True, rngs={"gumbel": jax.random.PRNGKey(key)})
        return out.loss, out

    (loss, out), grads = jax.value_and_grad(f, has_aux=True)(params)
    return float(loss), out, grads_from_jax(jax.device_get(grads))


def _assert_grads_close(tm, want):
    worst = 0.0
    for name, p in tm.named_parameters():
        g, w = p.grad, want[name]
        top = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= GRAD_TOL * max(top, 1e-30), (name, err, top)
        worst = max(worst, err / max(top, 1e-30))
    return worst


# ---- losses and Gumbel ----

def test_losses_match():
    x_hat, x = _rand((9, 14), 0), _rand((9, 14), 1)
    x[:, -4:] = (x[:, -4:] > 0).astype(np.float32)
    for n_cat in (0, 4):
        want = np.asarray(jlosses.categorical_reconstruction_loss(jnp.asarray(x_hat), jnp.asarray(x), n_cat))
        got = tlosses.categorical_reconstruction_loss(torch.from_numpy(x_hat), torch.from_numpy(x), n_cat)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    logits = _rand((5, 7), 2) * 30  # large |z|: the stable form
    want = np.asarray(jlosses._bce_with_logits(jnp.asarray(logits), jnp.asarray((logits > 3).astype(np.float32))))
    got = tlosses._bce_with_logits(torch.from_numpy(logits), torch.from_numpy((logits > 3).astype(np.float32)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    q, v = _rand((6, 8), 3), _rand((6, 8), 4)
    want = np.asarray(jlosses.quantize_loss(jnp.asarray(q), jnp.asarray(v), 0.25))
    np.testing.assert_allclose(tlosses.quantize_loss(torch.from_numpy(q), torch.from_numpy(v), 0.25).numpy(), want, **TOL)
    # the stop-gradients: d/dq = 2 beta (q - v), d/dv = -2 (q - v)
    jq_, jv = jax.grad(lambda a, b: jnp.sum(jlosses.quantize_loss(a, b, 0.25)), argnums=(0, 1))(jnp.asarray(q), jnp.asarray(v))
    tq_, tv = torch.from_numpy(q).requires_grad_(), torch.from_numpy(v).requires_grad_()
    tlosses.quantize_loss(tq_, tv, 0.25).sum().backward()
    np.testing.assert_allclose(tq_.grad.numpy(), np.asarray(jq_), **TOL)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jv), **TOL)


def test_gumbel_softmax_with_fed_noise_matches():
    logits, key = _rand((6, 10), 5), jax.random.PRNGKey(7)
    g = np.array(j_sample_gumbel(key, logits.shape))
    from rqvae_tpu.ops.gumbel import gumbel_softmax_sample as j_gs

    want = np.asarray(j_gs(key, jnp.asarray(logits), 0.3))
    got = tgumbel.gumbel_softmax_sample(torch.from_numpy(logits), 0.3, noise=torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    a = tgumbel.sample_gumbel((4000,), torch.Generator().manual_seed(0))
    b = tgumbel.sample_gumbel((4000,), torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    assert abs(float(a.mean()) - 0.5772) < 0.05 and abs(float(a.var()) - np.pi ** 2 / 6) < 0.15  # Gumbel(0, 1)
    with pytest.raises(ValueError):
        tgumbel.gumbel_softmax_sample(torch.from_numpy(logits), 0.3)


# ---- one quantization level ----

@pytest.mark.parametrize("mode", ["STE", "ROTATION_TRICK", "GUMBEL_SOFTMAX"])
def test_quantize_forward_values_and_gradients(mode):
    x, cb = _rand((12, 8), 6), _rand((16, 8), 7)
    key = jax.random.PRNGKey(11)
    g = np.array(j_sample_gumbel(key, (12, 16)))
    jmode, tmode = MODES[mode]

    def jf(xx, cc):
        out = jq.quantize_forward(xx, cc, mode=jmode, training=True, temperature=0.5, key=key)
        return jnp.sum(out.embeddings * jnp.arange(8.0)) + jnp.sum(out.loss), out

    (jval, jout), (jgx, jgc) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(cb))
    tx, tc = torch.from_numpy(x).requires_grad_(), torch.from_numpy(cb).requires_grad_()
    tout = tq.quantize_forward(tx, tc, mode=tmode, training=True, temperature=0.5, noise=torch.from_numpy(g))
    (torch.sum(tout.embeddings * torch.arange(8.0)) + tout.loss.sum()).backward()
    np.testing.assert_array_equal(tout.ids.numpy(), np.asarray(jout.ids))
    np.testing.assert_allclose(tout.embeddings.detach().numpy(), np.asarray(jout.embeddings), **TOL)
    np.testing.assert_allclose(tout.loss.detach().numpy(), np.asarray(jout.loss), **TOL)
    for got, want in ((tx.grad.numpy(), np.asarray(jgx)), (tc.grad.numpy(), np.asarray(jgc))):
        assert np.abs(got - want).max() <= GRAD_TOL * np.abs(want).max()


def test_rotation_transform_matches():
    u, q, e = _rand((5, 8), 1), _rand((5, 8), 2), _rand((5, 8), 3)
    want = np.asarray(jq.efficient_rotation_trick_transform(jnp.asarray(u), jnp.asarray(q), jnp.asarray(e)))
    got = tq.efficient_rotation_trick_transform(torch.from_numpy(u), torch.from_numpy(q), torch.from_numpy(e))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


class TestQuantizeForward:
    """tests/test_rqvae.py::TestQuantizeForward on the port."""

    def setup_method(self):
        self.x = torch.from_numpy(_rand((8, 16), 0))
        self.cb = torch.from_numpy(_rand((32, 16), 1))

    def test_l2_distance_matches_bruteforce(self):
        d = tq.codebook_distances(self.x, self.cb, tq.QuantizeDistance.L2).numpy()
        brute = ((self.x.numpy()[:, None] - self.cb.numpy()[None]) ** 2).sum(-1)
        np.testing.assert_allclose(d, brute, atol=1e-3)

    def test_cosine_distance(self):
        d = tq.codebook_distances(self.x, self.cb, tq.QuantizeDistance.COSINE).numpy()
        xn = self.x.numpy() / np.linalg.norm(self.x.numpy(), axis=1, keepdims=True)
        cn = self.cb.numpy() / np.linalg.norm(self.cb.numpy(), axis=1, keepdims=True)
        np.testing.assert_allclose(d, -(xn @ cn.T), atol=1e-5)

    def test_rotation_transform_linear_in_e(self):
        """With u, q fixed the transform is linear in e: its directional
        derivative equals the finite difference."""
        u, q, e = (torch.from_numpy(_rand((4, 8), s)) for s in (2, 3, 4))
        de = 1e-3 * torch.from_numpy(_rand((4, 8), 5))
        f = lambda ee: tq.efficient_rotation_trick_transform(u, q, ee)
        _, jvp = torch.func.jvp(f, (e,), (de,))
        np.testing.assert_allclose(jvp.numpy(), (f(e + de) - f(e)).numpy(), atol=1e-5)

    def test_eval_path_hard_lookup(self):
        out = tq.quantize_forward(self.x, self.cb, mode=tq.QuantizeForwardMode.STE, training=False)
        d = ((self.x.numpy()[:, None] - self.cb.numpy()[None]) ** 2).sum(-1)
        np.testing.assert_array_equal(out.ids.numpy(), d.argmin(1))
        np.testing.assert_allclose(out.embeddings.numpy(), self.cb.numpy()[d.argmin(1)])

    def test_ste_forward_and_gradient(self):
        x = self.x.clone().requires_grad_()
        out = tq.quantize_forward(x, self.cb, mode=tq.QuantizeForwardMode.STE, training=True)
        np.testing.assert_allclose(out.embeddings.detach().numpy(), self.cb.numpy()[out.ids.numpy()], atol=1e-6)
        out.embeddings.sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), np.ones((8, 16)), atol=1e-6)

    def test_gumbel_near_zero_temperature_is_hard(self):
        out = tq.quantize_forward(self.x, self.cb, mode=tq.QuantizeForwardMode.GUMBEL_SOFTMAX, training=True,
                                  temperature=1e-4, generator=torch.Generator().manual_seed(0))
        emb, cb = out.embeddings.numpy(), self.cb.numpy()
        assert (np.min(((emb[:, None] - cb[None]) ** 2).sum(-1), axis=1) < 1e-3).all()

    def test_gumbel_gradients_flow_to_codebook(self):
        cb = self.cb.clone().requires_grad_()
        out = tq.quantize_forward(self.x, cb, mode=tq.QuantizeForwardMode.GUMBEL_SOFTMAX, training=True,
                                  temperature=0.5, generator=torch.Generator().manual_seed(1))
        out.embeddings.sum().backward()
        assert float(cb.grad.abs().sum()) > 0

    def test_gumbel_requires_key(self):
        with pytest.raises(ValueError):
            tq.quantize_forward(self.x, self.cb, mode=tq.QuantizeForwardMode.GUMBEL_SOFTMAX, training=True)

    def test_rotation_trick_value_oracle(self):
        x, cb = self.x.numpy(), self.cb.numpy()
        out = tq.quantize_forward(self.x, self.cb, mode=tq.QuantizeForwardMode.ROTATION_TRICK, training=True)
        emb = cb[out.ids.numpy()]
        u = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-8)
        q = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-8)
        w = (u + q) / np.maximum(np.linalg.norm(u + q, axis=1, keepdims=True), 1e-6)
        rot = x - 2 * (x * w).sum(1, keepdims=True) * w + 2 * (x * u).sum(1, keepdims=True) * q
        scale = np.linalg.norm(emb, axis=1, keepdims=True) / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-6)
        np.testing.assert_allclose(out.embeddings.numpy(), rot * scale, atol=1e-4)
        np.testing.assert_allclose(out.embeddings.numpy(), emb, atol=1e-3)

    def test_quantize_loss_matches_formula(self):
        out = tq.quantize_forward(self.x, self.cb, mode=tq.QuantizeForwardMode.STE, training=True,
                                  commitment_weight=0.25)
        emb = self.cb.numpy()[out.ids.numpy()]
        np.testing.assert_allclose(out.loss.numpy(), 1.25 * ((self.x.numpy() - emb) ** 2).sum(-1), rtol=1e-4)


# ---- the RQ-VAE training forward and its gradients ----

@pytest.mark.parametrize("mode,n_cat", [("STE", 0), ("ROTATION_TRICK", 0), ("GUMBEL_SOFTMAX", 0), ("STE", 4),
                                        ("ROTATION_TRICK", 4)])
def test_forward_loss_and_every_gradient_match(monkeypatch, mode, n_cat):
    jm, params, tm, x = _models(mode, seed=1, n=48, n_cat_feats=n_cat)
    rec = _RecordJaxNoise(monkeypatch)
    jloss, jout, jgrads = _jax_loss_grads(jm, params, x, 0.4)
    noise = rec.torch_noise() if mode == "GUMBEL_SOFTMAX" else None
    assert len(rec.noise) == (3 if mode == "GUMBEL_SOFTMAX" else 0)
    out = tm(torch.from_numpy(x), 0.4, training=True, gumbel_noise=noise)
    out.loss.backward()
    np.testing.assert_allclose(out.loss.item(), jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(out.reconstruction_loss.item(), float(jout.reconstruction_loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(out.rqvae_loss.item(), float(jout.rqvae_loss), rtol=LOSS_RTOL, atol=1e-7)
    np.testing.assert_allclose(out.embs_norm.detach().numpy(), np.asarray(jout.embs_norm), **TOL)
    assert out.p_unique_ids.item() == pytest.approx(float(jout.p_unique_ids))
    _assert_grads_close(tm, jgrads)
    assert float(tm.codebooks.grad.abs().max()) > 0 and float(tm.encoder.layers[0].weight.grad.abs().max()) > 0


def test_training_ids_equal_eval_ids_away_from_ties():
    """The training forward picks the eval path's ids (STE, rotation trick)."""
    for mode in ("STE", "ROTATION_TRICK"):
        jm, params, tm, x = _models(mode, seed=2, n=64)
        want = jm.apply(params, jnp.asarray(x), training=False, method=JRqVae.get_semantic_ids)
        got = tm.get_semantic_ids(torch.from_numpy(x), training=True)
        np.testing.assert_array_equal(got.sem_ids.numpy(), np.asarray(want.sem_ids))
        assert got.embeddings.requires_grad


class TestRqVae:
    """tests/test_rqvae.py::TestRqVae on the port (and
    tests/test_quantize_variants.py::TestRotationKmeansInitParity,
    TestGumbelTraining)."""

    CFG = dict(input_dim=24, embed_dim=8, hidden_dims=(16, 12), codebook_size=16, n_layers=3, n_cat_feats=0)

    def _init(self, mode=tq.QuantizeForwardMode.STE, seed=0, batch=32, **over):
        model = RqVae(RqVaeConfig(**{**self.CFG, **over}, codebook_mode=mode), device="cpu", seed=seed)
        return model, torch.from_numpy(_rand((batch, over.get("input_dim", 24)), seed))

    def test_shapes(self):
        model, x = self._init()
        out = model.get_semantic_ids(x)
        assert out.sem_ids.shape == (32, 3) and out.sem_ids.dtype == torch.int32
        assert out.embeddings.shape == (32, 3, 8) and out.residuals.shape == (32, 3, 8)
        assert out.quantize_loss.shape == (32,)
        assert (out.sem_ids >= 0).all() and (out.sem_ids < 16).all()

    def test_residual_telescoping_identity(self):
        model, x = self._init()
        out = model.get_semantic_ids(x)
        enc = model.encode(x).detach()
        final_res = out.residuals[:, -1] - out.embeddings[:, -1]
        np.testing.assert_allclose(enc.numpy(), (out.embeddings.sum(1) + final_res).numpy(), atol=1e-5)

    def test_forward_losses(self):
        model, x = self._init()
        out = model(x, 0.2, training=True)
        assert np.isfinite(out.loss.item()) and out.p_unique_ids.item() <= 1.0 and out.embs_norm.shape == (32, 3)

    def test_p_unique_matches_bruteforce(self):
        model, x = self._init()
        out = model(x, 0.2, training=False)
        ids = model.get_semantic_ids(x).sem_ids.numpy()
        assert out.p_unique_ids.item() == pytest.approx(len({tuple(r) for r in ids}) / ids.shape[0])

    def test_categorical_path_normalizes_dense_slice(self):
        model, x = self._init(seed=7, hidden_dims=(16,), codebook_size=8, n_layers=2, n_cat_feats=4)
        assert np.isfinite(model(x, 0.2, training=True).loss.item())

    def test_kmeans_init_improves_quantization(self):
        model, x = self._init(batch=256)
        before = model.get_semantic_ids(x).quantize_loss.mean().item()
        kmeans_init_codebooks(model, x, torch.Generator().manual_seed(0))
        assert model.get_semantic_ids(x).quantize_loss.mean().item() < 0.5 * before

    def test_kmeans_init_gumbel_soft_residuals(self):
        """Level 0 is the same either way; at t = 0.2 the later levels see the
        soft mixture; other modes ignore the knob."""
        gm = tq.QuantizeForwardMode.GUMBEL_SOFTMAX
        cbs = {}
        for soft in (False, True):
            model, x = self._init(gm, seed=3, batch=256, hidden_dims=(16,), codebook_size=8)
            kmeans_init_codebooks(model, x, torch.Generator().manual_seed(0), gumbel_temperature=0.2 if soft else None)
            cbs[soft] = model.codebooks.detach().clone()
        assert torch.equal(cbs[False][0], cbs[True][0])
        assert float((cbs[False][1:] - cbs[True][1:]).abs().max()) > 1e-3 and torch.isfinite(cbs[True]).all()
        ste = []
        for t in (None, 0.2):
            model, x = self._init(seed=3, batch=256, hidden_dims=(16,), codebook_size=8)
            kmeans_init_codebooks(model, x, torch.Generator().manual_seed(0), gumbel_temperature=t)
            ste.append(model.codebooks.detach().clone())
        assert torch.equal(ste[0], ste[1])

    @pytest.mark.parametrize("mode", list(tq.QuantizeForwardMode))
    def test_train_step_decreases_loss(self, mode):
        model, x = self._init(mode, seed=1, batch=64)
        kmeans_init_codebooks(model, x, torch.Generator().manual_seed(5))
        opt = adamw(model.parameters(), 1e-3, weight_decay=0.01)
        step = tsteps.make_rqvae_train_step(model, opt)
        g = torch.Generator().manual_seed(0)
        first = None
        for _ in range(150):
            m = step(x[None], g, 0.2)
            first = m["reconstruction_loss"].item() if first is None else first
        assert np.isfinite(m["total_loss"].item()) and m["reconstruction_loss"].item() < first, mode

    def test_rotation_training_residuals_equal_eval_residuals(self):
        model, x = self._init(tq.QuantizeForwardMode.ROTATION_TRICK, seed=5, batch=64, hidden_dims=(16,), n_layers=2)
        tr = model.get_semantic_ids(x, 0.2, training=True)
        ev = model.get_semantic_ids(x, 0.2)
        np.testing.assert_allclose(tr.residuals.detach().numpy(), ev.residuals.numpy(), rtol=2e-4, atol=2e-5)
        assert torch.equal(tr.sem_ids, ev.sem_ids)

    def test_rotation_training_value_equals_hard_embedding(self):
        r = np.random.RandomState(3)
        x = torch.from_numpy((r.randn(512, 32) * r.uniform(0.05, 5.0, (512, 1))).astype(np.float32))
        cb = torch.from_numpy(r.randn(64, 32).astype(np.float32))
        out = tq.quantize_forward(x, cb, mode=tq.QuantizeForwardMode.ROTATION_TRICK, training=True)
        np.testing.assert_allclose(out.embeddings.numpy(), cb[out.ids.long()].numpy(), rtol=2e-4, atol=2e-5)

    def test_gumbel_mode_trains(self):
        model, x = self._init(tq.QuantizeForwardMode.GUMBEL_SOFTMAX, batch=48, hidden_dims=(16,), n_layers=2)
        opt = adamw(model.parameters(), 1e-3)
        step = tsteps.make_rqvae_train_step(model, opt)
        g = torch.Generator().manual_seed(0)
        first = step(x[None], g, 0.2)["reconstruction_loss"].item()
        for _ in range(119):
            last = step(x[None], g, 0.2)["reconstruction_loss"].item()
        assert np.isfinite(last) and last < first


# ---- the steps against the JAX steps ----

def test_three_optimizer_steps_match():
    """3 AdamW updates of the train step (STE, f32, 2 micro-batches each)
    from the same params on the same batches: loss, params and both moments."""
    jm, params, tm, _ = _models("STE", seed=4, n=64)
    tx = jstate.adamw(1e-3, weight_decay=0.1)
    jstep = jsteps.make_rqvae_train_step(jm, tx)
    state = jstate.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
    opt = adamw(tm.parameters(), 1e-3, weight_decay=0.1)
    tstep = tsteps.make_rqvae_train_step(tm, opt)
    for i in range(3):
        xb = _data(64, 24, 20 + i).reshape(2, 32, 24)
        state, jmet = jstep(state, jnp.asarray(xb), jax.random.PRNGKey(i), jnp.float32(0.2))
        tmet = tstep(torch.from_numpy(xb), None, 0.2)
        for k in ("total_loss", "reconstruction_loss", "rqvae_loss", "p_unique_ids", "gumbel_t"):
            np.testing.assert_allclose(tmet[k].item(), float(jmet[k]), rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(tmet["emb_norms"].numpy(), np.asarray(jmet["emb_norms"]), **TOL)
    want = grads_from_jax(jax.device_get(state.params))
    start = grads_from_jax(params)
    moved = 0.0
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5, rtol=0, err_msg=name)
        moved = max(moved, float((p.detach() - start[name]).abs().max()))
    adam = state.opt_state[0]
    names = [n for n, _ in tm.named_parameters()]
    for moments, jtree in ((opt.mu, adam.mu), (opt.nu, adam.nu)):
        jm_ = grads_from_jax(jax.device_get(jtree))
        for name, m in zip(names, moments):
            top = float(jm_[name].abs().max())
            assert float((m - jm_[name]).abs().max()) <= GRAD_TOL * top, name
    assert moved > 1e-3 and opt.count == 3 == int(adam.count)


def test_grad_accumulation_equals_big_batch():
    """2 micro-batches of 16 give the update of 1 batch of 32 (STE: no noise)."""
    model = RqVae(RqVaeConfig(**FIELDS, codebook_mode=tq.QuantizeForwardMode.STE), device="cpu", seed=0)
    other = RqVae(RqVaeConfig(**FIELDS, codebook_mode=tq.QuantizeForwardMode.STE), device="cpu", seed=0)
    x = torch.from_numpy(_rand((32, 24), 0))
    oa, ob = adamw(model.parameters(), 1e-3), adamw(other.parameters(), 1e-3)
    m1 = tsteps.make_rqvae_train_step(model, oa)(x[None], None, 0.2)
    m2 = tsteps.make_rqvae_train_step(other, ob)(x.reshape(2, 16, 24), None, 0.2)
    assert m2["total_loss"].item() == pytest.approx(m1["total_loss"].item(), rel=1e-4)
    for (name, pa), pb in zip(model.named_parameters(), other.parameters()):
        np.testing.assert_allclose(pa.grad.numpy(), pb.grad.numpy(), atol=1e-6, rtol=1e-4, err_msg=name)


def test_index_train_step_gathers_the_batch():
    features = torch.from_numpy(_rand((40, 24), 1))
    idx = torch.from_numpy(np.random.RandomState(2).randint(0, 40, (2, 8)))
    a = RqVae(RqVaeConfig(**FIELDS, codebook_mode=tq.QuantizeForwardMode.STE), device="cpu", seed=1)
    b = RqVae(RqVaeConfig(**FIELDS, codebook_mode=tq.QuantizeForwardMode.STE), device="cpu", seed=1)
    ma = tsteps.make_rqvae_index_train_step(a, adamw(a.parameters(), 1e-3))(features, idx, None, 0.2)
    mb = tsteps.make_rqvae_train_step(b, adamw(b.parameters(), 1e-3))(features[idx], None, 0.2)
    assert ma["total_loss"].item() == mb["total_loss"].item()
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)


def test_eval_step_matches():
    jm, params, tm, x = _models("ROTATION_TRICK", seed=6, n=40, n_cat_feats=4)
    want = jsteps.make_rqvae_eval_step(jm)(params, jnp.asarray(x), jnp.float32(0.2))
    got = tsteps.make_rqvae_eval_step(tm)(torch.from_numpy(x), 0.2)
    assert set(got) == set(want) == {"eval_total_loss", "eval_reconstruction_loss", "eval_rqvae_loss"}
    for k in got:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=LOSS_RTOL, atol=1e-7, err_msg=k)


def test_diversity_metrics_match():
    r = np.random.RandomState(8)
    ids = r.randint(0, 6, (300, 3)).astype(np.int32)
    ids[:, 2] = np.minimum(ids[:, 2], 2)  # level 2 uses 3 of 8 codes
    keys = np.asarray(jdedup.pack_sem_id_tuples(jnp.asarray(ids), 8))
    np.testing.assert_allclose(tdedup.tuple_entropy(torch.from_numpy(keys)).item(),
                               float(jdedup.tuple_entropy(jnp.asarray(keys))), rtol=1e-6)
    np.testing.assert_allclose(tdedup.codebook_usage(torch.from_numpy(ids), 8).numpy(),
                               np.asarray(jdedup.codebook_usage(jnp.asarray(ids), 8)), **TOL)
