"""Worker of the port's multi-process tests (tests/test_torch_data_parallel.py,
tests/test_torch_dp_trainers.py): one rank of a data-parallel run of
rqvae_tpu_torch on the CPU, over gloo.

    python tests/torch_dist_worker.py SPEC.json

The launcher (`launch`, below) sets the JAX package's manual markers
(RQVAE_TPU_NUM_PROCESSES, RQVAE_TPU_PROCESS_ID, JAX_COORDINATOR_ADDRESS),
which rqvae_tpu_torch.parallel.dist reads. The spec lists scenarios; each
rank runs them in order and writes what it saw to
`<out>/<scenario name>.rank<r>.pt`, then prints one JSON line. This script
imports torch and rqvae_tpu_torch, never JAX or rqvae_tpu
(tests/test_torch_convert.py holds it to that).
"""

import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.abspath(__file__)
MARKERS = ("RQVAE_TPU_NUM_PROCESSES", "RQVAE_TPU_PROCESS_ID", "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
           "RQVAE_TPU_DISTRIBUTED", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
           "MASTER_PORT")


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(nprocs: int, spec_path: str, timeout: float = 240.0, argv=None) -> list:
    """Run `nprocs` ranks (this worker on `spec_path`, or `argv`) and gather
    every one before judging: a rank that hangs or dies has its peers killed,
    and every rank's stderr is reported. Returns each rank's last stdout
    line, parsed as JSON when it is."""
    port = free_port()
    procs = []
    for rank in range(nprocs):
        env = {k: v for k, v in os.environ.items() if k not in MARKERS}
        env.update(RQVAE_TPU_NUM_PROCESSES=str(nprocs), RQVAE_TPU_PROCESS_ID=str(rank),
                   JAX_COORDINATOR_ADDRESS=f"localhost:{port}", OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
        cmd = [sys.executable, WORKER, spec_path] if argv is None else list(argv)
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                                      cwd=REPO))
    deadline = time.monotonic() + timeout
    results = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                out, err = p.communicate()
                err = f"[TIMED OUT]\n{err}"
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if not all(rc == 0 for rc, _, _ in results):
        raise AssertionError("\n".join(f"--- rank {i} rc={rc} ---\n{err[-3000:]}"
                                       for i, (rc, _, err) in enumerate(results)))
    lines = []
    for _, out, _ in results:
        last = out.strip().splitlines()[-1] if out.strip() else ""
        try:
            lines.append(json.loads(last))
        except ValueError:
            lines.append(out)
    return lines


def _enums(kw: dict) -> dict:
    from rqvae_tpu_torch.data.registry import RecDataset
    from rqvae_tpu_torch.models.quantize import QuantizeForwardMode

    kw = dict(kw)
    for k in ("dataset",):
        if isinstance(kw.get(k), str):
            kw[k] = RecDataset[kw[k]]
    for k in ("vae_codebook_mode", "codebook_mode"):
        if isinstance(kw.get(k), str):
            kw[k] = QuantizeForwardMode[kw[k]]
    return kw


def _optimizer(params, opt: dict):
    from rqvae_tpu_torch.ops.schedules import inverse_sqrt_schedule
    from rqvae_tpu_torch.train.state import adamw

    lr = opt["lr"] if opt.get("warmup") is None else inverse_sqrt_schedule(opt["lr"], opt["warmup"])
    return adamw(params, lr, weight_decay=opt.get("wd", 0.01), max_grad_norm=opt.get("max_grad_norm"))


def _scalars(metrics: dict) -> dict:
    return {k: v.detach().cpu().clone() for k, v in metrics.items()}


def decoder_step(sc: dict, replicas) -> dict:
    """Steps of the stage-2 data-parallel step (or the shard_map step) on
    this rank's rows of each global batch."""
    import torch

    from rqvae_tpu_torch.data.schemas import TokenizedSeqBatch
    from rqvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel, RetrievalConfig
    from rqvae_tpu_torch.parallel.mesh import local_rows
    from rqvae_tpu_torch.train import decoder_steps

    model = EncoderDecoderRetrievalModel(RetrievalConfig(**sc["config"]), device="cpu")
    model.load_state_dict(torch.load(sc["state_dict"]))
    opt = _optimizer(model.parameters(), sc["opt"])
    make = decoder_steps.make_decoder_shardmap_train_step if sc.get("shardmap") else \
        decoder_steps.make_decoder_train_step
    step = make(model, opt, replicas)
    data = torch.load(sc["batches"])
    metrics = []
    for i, b in enumerate(data["batches"]):
        rows = local_rows(b["sem_ids"].shape[0], replicas.rank, replicas.world)
        batch = TokenizedSeqBatch(**{k: v[rows] for k, v in b.items()})
        seeds = None if data.get("seeds") is None else data["seeds"][i]
        metrics.append(_scalars(step(batch, seeds=seeds)))
    return {"metrics": metrics, "params": {k: v.clone() for k, v in model.state_dict().items()},
            "seed_rows": None if data.get("seeds") is None else
            [decoder_steps.DropoutSeeds.fold_in(s, replicas.rank) for s in data["seeds"]]}


def decoder_graph(sc: dict, replicas) -> dict:
    """Chunks of the stage-2 data-parallel step (train/decoder_steps.py::
    DecoderGraphTrainStep) on this rank's device, from a seeded model over a
    seeded row store: on a card under NCCL each step a replay of one CUDA
    graph. Returns the parameters, the chunk means and, with a graph, the
    kernels among its nodes by name."""
    import re
    import tempfile

    import numpy as np
    import torch

    from rqvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel, RetrievalConfig
    from rqvae_tpu_torch.train.decoder_steps import make_decoder_graph_train_step

    dev = torch.device("cuda", torch.cuda.current_device()) if sc["device"] == "cuda" else torch.device("cpu")
    model = EncoderDecoderRetrievalModel(RetrievalConfig(**sc["config"]), device=dev, seed=2)
    opt = _optimizer(model.parameters(), sc["opt"])
    r = np.random.RandomState(0)
    rows, T, n_items = 48, 14, 40
    seq_items = r.randint(0, n_items, (rows, T))
    seq_lengths = r.randint(5, T + 1, rows)
    seq_items[np.arange(T)[None, :] >= seq_lengths[:, None]] = -1
    cached = r.randint(0, sc["config"]["codebook_size"], (n_items, 4))
    cached[:, -1] = 0
    store = [torch.as_tensor(a, device=dev) for a in (seq_items, seq_lengths, np.arange(rows),
                                                      cached.astype(np.int32))]
    step = make_decoder_graph_train_step(model, opt, max_seq_len=6, n_steps=sc["n_steps"], batch_size=sc["batch"],
                                         replicas=replicas)
    draws = [step.draws(3, s, rows) for s in range(sc["steps"])]
    n = sc["n_steps"]
    means = [_scalars(step(*store, draws[i:i + n])) for i in range(0, sc["steps"], n)]
    kernels = None
    if step.chunks.graph is not None:
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/graph.dot"
            step.chunks.graph.debug_dump(path)
            with open(path) as f:
                kernels = re.findall(r'label="\{KERNEL\n\| \{ID \| \d+ \(topoId: \d+\) \| ([^}\\]*)', f.read())
    return {"params": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}, "metrics": means,
            "graph_kernels": kernels}


def rqvae_step(sc: dict, replicas) -> dict:
    """Steps of the stage-1 data-parallel step on this rank's rows of each
    global [A, B, D] batch, Gumbel uniforms from the generator of step i."""
    import torch

    from rqvae_tpu_torch.models.rqvae import RqVae, RqVaeConfig
    from rqvae_tpu_torch.parallel.mesh import local_rows
    from rqvae_tpu_torch.train.rqvae_steps import make_rqvae_train_step

    cfg = RqVaeConfig(**_enums(sc["config"]))
    model = RqVae(cfg, device="cpu")
    model.load_state_dict(torch.load(sc["state_dict"]))
    opt = _optimizer(model.parameters(), sc["opt"])
    step = make_rqvae_train_step(model, opt, replicas)
    xs = torch.load(sc["x"])
    metrics = []
    for i, x in enumerate(xs):
        rows = local_rows(x.shape[1], replicas.rank, replicas.world)
        g = torch.Generator().manual_seed(sc["gen_seed"] + i)
        metrics.append(_scalars(step(x[:, rows], g, sc["gumbel_t"])))
    return {"metrics": metrics, "params": {k: v.clone() for k, v in model.state_dict().items()}}


def trainer(sc: dict, replicas) -> dict:
    """Calls of train_decoder.train or train_rqvae.train, in order."""
    from rqvae_tpu_torch.train import train_decoder, train_rqvae

    fn = {"train_decoder": train_decoder.train, "train_rqvae": train_rqvae.train}[sc["kind"]]
    return {"summaries": [fn(**_enums(kw)) for kw in sc["calls"]]}


def main(spec_path: str) -> None:
    import torch

    torch.set_num_threads(1)
    from rqvae_tpu_torch.parallel import dist

    with open(spec_path) as f:
        spec = json.load(f)
    backend = dist.initialize_distributed(spec.get("device", "cpu"))
    replicas = dist.replicas()
    run = {"decoder_step": decoder_step, "decoder_graph": decoder_graph, "rqvae_step": rqvae_step,
           "train_decoder": trainer, "train_rqvae": trainer}
    for sc in spec["scenarios"]:
        result = run[sc["kind"]](sc, replicas)
        torch.save(result, os.path.join(spec["out"], f"{sc['name']}.rank{replicas.rank}.pt"))
    print(json.dumps({"rank": dist.process_index(), "world": dist.process_count(), "backend": backend,
                      "done": [sc["name"] for sc in spec["scenarios"]]}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main(sys.argv[1])
