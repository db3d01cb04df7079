"""The port's scale-out helpers on the CPU, in one process: the launch gate of
parallel/dist.py (mirroring tests/test_mesh_helpers.py's TestDistGate, plus
torchrun's markers and the backend choice), parallel/mesh.py's mesh and row
splits (tests/test_parallel.py:28-36, test_mesh_helpers.py:18-47),
data/loader.py, and the dropout counters a data-parallel rank starts from
its first global row: keep_mask / hash_dropout with an offset, the attention
keep mask at b0 = r * B against the JAX package's dropout_keep_oracle, and a
whole training forward on a rank's rows against the rows of the global
forward (f32, atol 1e-5: the same per-row arithmetic at another batch size).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rqvae_tpu.data import datasets as jdata
from rqvae_tpu.data import loader as jloader
from rqvae_tpu.ops import hash_dropout as jhash
from rqvae_tpu.ops.pallas.attention import dropout_keep_oracle

from rqvae_tpu_torch.data import datasets as tdata
from rqvae_tpu_torch.data import loader as tloader
from rqvae_tpu_torch.data.registry import RecDataset, ensure_dataset
from rqvae_tpu_torch.data.schemas import SeqBatch, TokenizedSeqBatch
from rqvae_tpu_torch.models import retrieval as tr
from rqvae_tpu_torch.models.t5 import DropoutSeeds, SiteSeeds
from rqvae_tpu_torch.ops.hash_dropout import attention_keep_mask, hash_dropout, keep_mask
from rqvae_tpu_torch.parallel import dist, mesh

MARKERS = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "RQVAE_TPU_DISTRIBUTED", "RQVAE_TPU_NUM_PROCESSES",
           "RQVAE_TPU_PROCESS_ID", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
           "MASTER_PORT", "TPU_WORKER_HOSTNAMES", "MEGASCALE_COORDINATOR_ADDRESS")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def env(monkeypatch):
    for k in MARKERS:
        monkeypatch.delenv(k, raising=False)

    def set_(**kw):
        for k in MARKERS:
            monkeypatch.delenv(k, raising=False)
        for k, v in kw.items():
            monkeypatch.setenv(k, v)
        return dist.launch_from_env()

    return set_


class TestDistGate:
    def test_no_markers_no_group(self, env):
        assert env() is None
        # a TPU host's own name is no marker here either, nor one for the port at all
        assert env(TPU_WORKER_HOSTNAMES="localhost") is None
        assert env(RQVAE_TPU_DISTRIBUTED="0", JAX_COORDINATOR_ADDRESS="h:1234", RQVAE_TPU_NUM_PROCESSES="2",
                   RQVAE_TPU_PROCESS_ID="0") is None
        assert dist.initialize_distributed("cpu") is None and dist.replicas() is None
        assert dist.process_count() == 1 and dist.is_main_process()

    def test_manual_markers(self, env):
        got = env(JAX_COORDINATOR_ADDRESS="localhost:9999", RQVAE_TPU_NUM_PROCESSES="2", RQVAE_TPU_PROCESS_ID="1")
        assert got == dist.Launch(world=2, rank=1, local_rank=1, local_world=2, address="localhost:9999")
        got = env(COORDINATOR_ADDRESS="h:1", RQVAE_TPU_NUM_PROCESSES="4", RQVAE_TPU_PROCESS_ID="3", LOCAL_RANK="0")
        assert got == dist.Launch(4, 3, 0, 4, "h:1")

    def test_missing_id_or_coordinator_raises(self, env):
        with pytest.raises(ValueError, match="coordinator"):
            env(RQVAE_TPU_NUM_PROCESSES="2", RQVAE_TPU_PROCESS_ID="1")
        with pytest.raises(ValueError, match="RQVAE_TPU_PROCESS_ID"):
            env(RQVAE_TPU_NUM_PROCESSES="2", JAX_COORDINATOR_ADDRESS="h:1")
        # a coordinator alone names no world: the port cannot auto-detect one as a TPU pod does
        with pytest.raises(ValueError, match="RQVAE_TPU_NUM_PROCESSES"):
            env(JAX_COORDINATOR_ADDRESS="h:1234")
        with pytest.raises(ValueError, match="RQVAE_TPU_NUM_PROCESSES"):
            env(RQVAE_TPU_DISTRIBUTED="1")
        with pytest.raises(ValueError, match="rank 2 of a world of 2"):
            env(RQVAE_TPU_NUM_PROCESSES="2", RQVAE_TPU_PROCESS_ID="2", JAX_COORDINATOR_ADDRESS="h:1")
        with pytest.raises(ValueError, match="host:port"):
            env(RQVAE_TPU_NUM_PROCESSES="2", RQVAE_TPU_PROCESS_ID="0", JAX_COORDINATOR_ADDRESS="h")

    @pytest.mark.parametrize("bad", ["true", "yes", "2"])
    def test_force_knob_rejects_typos(self, env, bad):
        with pytest.raises(ValueError, match="RQVAE_TPU_DISTRIBUTED"):
            env(RQVAE_TPU_DISTRIBUTED=bad)

    def test_torchrun_markers(self, env):
        got = env(WORLD_SIZE="4", RANK="3", LOCAL_RANK="1", LOCAL_WORLD_SIZE="2", MASTER_ADDR="h", MASTER_PORT="29500")
        assert got == dist.Launch(4, 3, 1, 2, "h:29500")
        assert env(WORLD_SIZE="2", RANK="1", MASTER_ADDR="h", MASTER_PORT="1") == dist.Launch(2, 1, 1, 2, "h:1")
        with pytest.raises(ValueError, match="MASTER_PORT"):
            env(WORLD_SIZE="2", RANK="1", MASTER_ADDR="h")

    def test_backend_and_card_choice(self, monkeypatch):
        launch = dist.Launch(4, 3, 3, 4, "h:1")
        assert dist.choose_backend(torch.device("cpu"), launch) == "gloo"
        assert dist.rank_device("cpu", launch) == torch.device("cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        for cards, backend, card in ((4, "nccl", 3), (2, "gloo", 1), (1, "gloo", 0)):
            monkeypatch.setattr(torch.cuda, "device_count", lambda cards=cards: cards)
            dev = dist.rank_device(None, launch)
            assert dev == torch.device("cuda", card)  # cuda:(local_rank % device_count)
            assert dist.choose_backend(dev, launch) == backend  # nccl only for distinct cards

    def test_initialize_joins_the_group_it_names(self, env, monkeypatch):
        """init_process_group gets the markers' world, rank and address and
        the chosen backend; the first all-reduce must see every rank."""
        env(JAX_COORDINATOR_ADDRESS="localhost:9999", RQVAE_TPU_NUM_PROCESSES="2", RQVAE_TPU_PROCESS_ID="1")
        calls = []
        monkeypatch.setattr(dist.tdist, "init_process_group", lambda backend, **kw: calls.append((backend, kw)))
        monkeypatch.setattr(dist.tdist, "all_reduce", lambda t: t.fill_(2.0))
        assert dist.initialize_distributed("cpu") == "gloo"
        backend, kw = calls[0]
        assert backend == "gloo" and kw["init_method"] == "tcp://localhost:9999"
        assert kw["world_size"] == 2 and kw["rank"] == 1 and "device_id" not in kw
        monkeypatch.setattr(dist.tdist, "all_reduce", lambda t: t.fill_(1.0))
        with pytest.raises(RuntimeError, match="first all-reduce"):
            dist.initialize_distributed("cpu")  # a peer missing: raise, never carry on alone


class TestMesh:
    def test_make_mesh_shapes(self):
        m = mesh.make_mesh(devices=["cpu"] * 8)
        assert m.shape == {"data": 8, "model": 1} and m.axis_names == ("data", "model")
        assert m.data_devices == [torch.device("cpu")] * 8
        assert mesh.make_mesh(n_data=2, devices=["cpu", "cpu"]).shape["data"] == 2
        with pytest.raises(ValueError, match="3 x 1 mesh over 2"):
            mesh.make_mesh(n_data=3, devices=["cpu", "cpu"])

    def test_tensor_parallel_is_not_ported(self):
        with pytest.raises(NotImplementedError, match="tp.py"):
            mesh.make_mesh(n_data=4, n_model=2, devices=["cpu"] * 8)

    def test_row_split(self):
        """Contiguous 'data' shards of ceil(n / shards) rows, as a batch
        sharded over 'data' (tests/test_mesh_helpers.py:18-39: 16 rows over
        8 devices, 2 each)."""
        m = mesh.make_mesh(devices=["cpu"] * 8)
        x = torch.arange(16 * 4).reshape(16, 4)
        parts = mesh.shard_rows(m, x)
        assert [p.shape for p in parts] == [(2, 4)] * 8 and torch.equal(torch.cat(parts), x)
        assert mesh.shard_sizes(10, 4) == [3, 3, 3, 1] and mesh.shard_sizes(2, 4) == [1, 1, 0, 0]
        assert mesh.shard_sizes(0, 3) == [0, 0, 0]
        y = torch.arange(2 * 10 * 3).reshape(2, 10, 3)
        assert torch.equal(torch.cat(mesh.shard_rows(mesh.make_mesh(devices=["cpu"] * 4), y, axis=1), 1), y)

    def test_local_rows_and_replicate(self):
        assert mesh.local_rows(16, 1, 2) == slice(8, 16) and mesh.local_rows(6, 0, 3) == slice(0, 2)
        with pytest.raises(ValueError, match="does not divide over 3"):
            mesh.local_rows(16, 0, 3)
        model = torch.nn.Linear(3, 2)
        reps = mesh.replicate(model, [torch.device("cpu")] * 2)
        assert list(reps) == [torch.device("cpu")] and reps[torch.device("cpu")] is model
        t = torch.ones(3)
        assert mesh.replicate(t, ["cpu"])[torch.device("cpu")] is t

    @pytest.mark.parametrize("rank", [0, 1, 2])
    def test_rank_slice(self, rank):
        """A rank keeps its local_rows of each named draw along that draw's
        batch dimension, every other draw whole; the three ranks' slices
        put back together are the global draws; a process alone keeps all."""
        r = dist.Replicas(rank, 3, "gloo")
        draws = {"idx": torch.arange(2 * 6).reshape(2, 6), "uniforms": torch.rand(2, 3, 6, 4),
                 "seeds": torch.arange(5)}
        axes = {"idx": 1, "uniforms": 2, "absent": 0}
        got = mesh.rank_slice(draws, r, axes)
        rows = mesh.local_rows(6, rank, 3)
        assert set(got) == set(draws) and got["seeds"] is draws["seeds"]
        assert torch.equal(got["idx"], draws["idx"][:, rows])
        assert torch.equal(got["uniforms"], draws["uniforms"][:, :, rows])
        every = [mesh.rank_slice(draws, dist.Replicas(i, 3, "gloo"), axes) for i in range(3)]
        assert torch.equal(torch.cat([e["uniforms"] for e in every], 2), draws["uniforms"])
        alone = mesh.rank_slice(draws, None, axes)
        assert all(alone[k] is draws[k] for k in draws)
        with pytest.raises(ValueError, match="does not divide"):
            mesh.rank_slice({"idx": torch.zeros(2, 7)}, r, axes)


def test_loader_draws_the_jax_loaders_batches(tmp_path):
    """infinite_batches: the same numpy draws as the JAX loader's; to_device
    turns every leaf into a tensor on the device."""
    data = ensure_dataset(str(tmp_path / "ds"), RecDataset.SYNTHETIC)
    jit = jloader.infinite_batches(jdata.ItemDataset(data, "train"), 8, seed=3)
    tit = tloader.infinite_batches(tdata.ItemDataset(data, "train"), 8, seed=3)
    for _ in range(3):
        np.testing.assert_array_equal(next(jit), next(tit))
    b = SeqBatch(user_ids=np.arange(4), ids=np.zeros((4, 3), np.int64), ids_fut=np.arange(4), x=None,
                 x_fut=None, seq_mask=np.ones((4, 3), bool))
    got = tloader.to_device(b, "cpu")
    assert isinstance(got, SeqBatch) and got.x is None and got.ids.dtype == torch.int64
    assert torch.equal(got.seq_mask, torch.ones(4, 3, dtype=torch.bool))
    assert tloader.to_device({"a": [np.ones(2)]}, "cpu")["a"][0].dtype == torch.float64


class TestRankCounters:
    def test_keep_mask_offset_is_a_slice_of_the_global_mask(self):
        for shape, seed in (((6, 5, 4), 7), ((4, 3, 2, 8), -(2**31) + 5)):
            whole = np.asarray(jhash.keep_mask(jnp.int32(seed), shape, 0.3))
            per_row = int(np.prod(shape[1:]))
            for r in range(2):
                rows = shape[0] // 2
                got = keep_mask(seed, (rows, *shape[1:]), 0.3, offset=r * rows * per_row,
                                total=shape[0] * per_row)
                np.testing.assert_array_equal(got.numpy(), whole[r * rows:(r + 1) * rows])

    def test_overflow_is_checked_on_the_global_count(self):
        """A rank's mask is small, the global one is not: the JAX check sees
        the global shape and raises, so must the port's."""
        with pytest.raises(ValueError, match="overflows"):
            keep_mask(1, (2, 3), 0.1, offset=0, total=2**32)
        with pytest.raises(ValueError, match="outside a global array"):
            keep_mask(1, (2, 3), 0.1, offset=4, total=8)
        x = torch.ones(2, 3, requires_grad=True)
        with pytest.raises(ValueError, match="overflows"):
            hash_dropout(x, 1, 0.1, offset=6, total=2**32 + 6)

    def test_hash_dropout_rows_equal_the_global_ops(self):
        x = torch.randn(8, 5, 3, generator=torch.Generator().manual_seed(0), requires_grad=True)
        g = torch.randn(8, 5, 3, generator=torch.Generator().manual_seed(1))
        whole = hash_dropout(x, 11, 0.25)
        whole.backward(g)
        for r in range(2):
            xr = x.detach()[4 * r:4 * r + 4].clone().requires_grad_(True)
            got = hash_dropout(xr, 11, 0.25, offset=r * 60, total=120)
            got.backward(g[4 * r:4 * r + 4])
            assert torch.equal(got, whole[4 * r:4 * r + 4]) and torch.equal(xr.grad, x.grad[4 * r:4 * r + 4])

    def test_attention_keep_mask_at_b0_equals_the_jax_oracle_slice(self):
        B, H, Lq, Lk = 6, 3, 5, 7
        whole = np.asarray(dropout_keep_oracle(jnp.int32(99), B, H, Lq, Lk, 0.2))
        for r in range(3):
            got = attention_keep_mask(99, 2, H, Lq, Lk, 0.2, b0=2 * r)
            np.testing.assert_array_equal(got.numpy(), whole[2 * r:2 * r + 2])

    def test_fold_in_gives_each_rank_its_own_seeds(self):
        seeds = DropoutSeeds.draw(torch.Generator().manual_seed(0), 2, 20)
        folded = [DropoutSeeds.fold_in(seeds, r) for r in range(3)]
        for i, f in enumerate(folded):
            assert f.dtype == torch.int32 and f.shape == seeds.shape and bool((f >= 0).all())
            assert not torch.equal(f, seeds) and torch.equal(f, DropoutSeeds.fold_in(seeds, i))
            for g in folded[i + 1:]:
                assert bool((f != g).all())


def test_a_ranks_training_forward_equals_its_rows_of_the_global_forward():
    """SiteSeeds(seeds, b0, rows): every dropout site of the encoder and the
    decoder (hash sites and both attention routes: the kernel's plain version
    at the 24 encoder rows, plain attention in the 4-token decoder) draws the
    rank's slice of the global batch's masks, so the rank's logits are its
    rows of the global forward's; counting from 0 instead draws other masks."""
    L, K, B = 3, 8, 6
    cfg = tr.RetrievalConfig(num_hierarchies=L, codebook_size=K, t5_d_model=32, t5_d_kv=8, t5_num_heads=4,
                             t5_d_ff=64, t5_num_layers=2, t5_dropout=0.3, num_user_bins=7)
    model = tr.EncoderDecoderRetrievalModel(cfg, device="cpu", seed=0).train()
    r = np.random.RandomState(0)
    D = L + 1
    batch = TokenizedSeqBatch(
        user_ids=torch.from_numpy(r.randint(0, 100, B)), sem_ids=torch.from_numpy(r.randint(0, K, (B, 6 * D))),
        sem_ids_fut=torch.from_numpy(r.randint(0, K, (B, D))), seq_mask=torch.ones(B, 6 * D, dtype=torch.bool),
        token_type_ids=torch.arange(D).repeat(B, 6), token_type_ids_fut=torch.arange(D).repeat(B, 1))
    seeds = DropoutSeeds.draw(torch.Generator().manual_seed(5), 1, model.n_dropout_sites)[0]
    with torch.no_grad():
        whole = model(batch, training=True, seeds=seeds).logits
        for rank in range(2):
            rows = slice(3 * rank, 3 * rank + 3)
            part = TokenizedSeqBatch(*(t[rows] for t in batch))
            got = model(part, training=True, seeds=SiteSeeds(seeds, 3 * rank, B)).logits
            torch.testing.assert_close(got, whole[rows], atol=1e-5, rtol=0)
        alone = model(TokenizedSeqBatch(*(t[3:] for t in batch)), training=True, seeds=seeds).logits
        assert (alone - whole[3:]).abs().max() > 1e-2
