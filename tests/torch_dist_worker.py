"""Worker of the port's multi-process tests (tests/test_torch_data_parallel.py,
tests/test_torch_dp_trainers.py, tests/test_torch_tp.py,
tests/test_torch_checkpoint_sharded.py, and the card's in
tests/test_torch_kernels_gpu.py and tests/test_torch_paths_gpu.py): one rank
of a data-parallel or tensor-parallel run of rqvae_tpu_torch, on the CPU over
gloo or on the card.

    python tests/torch_dist_worker.py SPEC.json

The launcher (`launch`, below) sets the JAX package's manual markers
(RQVAE_TPU_NUM_PROCESSES, RQVAE_TPU_PROCESS_ID, JAX_COORDINATOR_ADDRESS),
which rqvae_tpu_torch.parallel.dist reads. The spec lists scenarios; each
rank runs them in order and writes what it saw to
`<out>/<scenario name>.rank<r>.pt`, then prints one JSON line. Each result
also holds the launches of the port's kernels during its scenario and the
(b0, h0, heads_total) that kernels 4 and 5 were launched with; a scenario's
"fault" plants one on rank 1 (`_recorded`), as a control that a test's gate
must catch. This script
imports torch and rqvae_tpu_torch, never JAX or rqvae_tpu
(tests/test_torch_convert.py holds it to that).
"""

import contextlib
import functools
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


def tp_step(sc: dict, replicas) -> dict:
    """Steps of the stage-2 step on an [n_data, n_model] mesh of the ranks
    (parallel/mesh.py::make_process_mesh): the model cut to this rank's
    shards (parallel/tp.py::shard_params), the rows of its data index of
    each global batch. Returns the gathered parameters and moments, the
    metrics, the shard-then-gather round trip and, with `generate`, the
    beams of the sharded model."""
    import torch

    from rqvae_tpu_torch.data.schemas import TokenizedSeqBatch
    from rqvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel, RetrievalConfig
    from rqvae_tpu_torch.parallel import tp
    from rqvae_tpu_torch.parallel.mesh import local_rows, make_process_mesh
    from rqvae_tpu_torch.serving.beam import build_prefix_table
    from rqvae_tpu_torch.train import decoder_steps

    dev = torch.device("cuda", torch.cuda.current_device()) if sc.get("device") == "cuda" else torch.device("cpu")
    mesh = make_process_mesh(sc["n_data"], sc["n_model"])
    model = EncoderDecoderRetrievalModel(RetrievalConfig(**sc["config"]), device=dev)
    whole = {k: v.to(dev) for k, v in torch.load(sc["state_dict"]).items()}
    model.load_state_dict(whole)
    tp.shard_params(mesh, model)
    out = {"round_trip": all(torch.equal(v, whole[k]) for k, v in tp.gather_params(model).items()),
           "local_shapes": {k: tuple(v.shape) for k, v in model.state_dict().items()}}
    data = torch.load(sc["batches"])
    if sc.get("generate"):
        b = data["batches"][0]
        table = build_prefix_table(data["corpus"].to(dev), sc["config"]["codebook_size"])
        g = model.generate(*(b[k].to(dev) for k in ("sem_ids", "seq_mask", "user_ids")), table)
        out["generate"] = {"sem_ids": g.sem_ids.cpu(), "log_probas": g.log_probas.cpu()}
        out["still_sharded"] = tp.shard_of(model) is not None and tuple(model.heads.shape) == \
            out["local_shapes"]["heads"]
    opt = _optimizer(model.parameters(), sc["opt"])
    step = decoder_steps.make_decoder_train_step(model, opt, mesh.data)
    d = 0 if mesh.data is None else mesh.data.rank
    metrics = []
    for i, b in enumerate(data["batches"][:sc["steps"]]):
        rows = local_rows(b["sem_ids"].shape[0], d, sc["n_data"])
        batch = TokenizedSeqBatch(**{k: v[rows].to(dev) for k, v in b.items()})
        seeds = None if data.get("seeds") is None else data["seeds"][i].to(dev)
        metrics.append(_scalars(step(batch, seeds=seeds)))
    names = [n for n, _ in model.named_parameters()]
    if metrics and opt.grad_norm is not None:  # the clip's norm of the last step's gradient, and the whole one's
        grads = [p.grad for _, p in model.named_parameters()]
        whole = tp.gather_params(model, dict(zip(names, grads)))
        out["grad_norm"] = (opt.grad_norm(grads).item(),
                            torch.linalg.vector_norm(torch.stack([g.norm() for g in whole.values()])).item())
    cpu = lambda t: {k: v.cpu() for k, v in t.items()}
    if metrics:
        out["grads"] = cpu(tp.gather_params(model, {n: p.grad for n, p in model.named_parameters()}))
    out.update(metrics=metrics, params=cpu(tp.gather_params(model)),
               mu=cpu(tp.gather_params(model, dict(zip(names, opt.mu)))), mesh=(d, mesh.model.rank),
               backend=mesh.model.backend)
    return out


def ckpt_sharded(sc: dict, replicas) -> dict:
    """Save a model's parameters and AdamW state with every rank
    (utils/checkpoint_sharded.py), then load them back, with and without
    templates."""
    import torch

    from rqvae_tpu_torch.models.retrieval import EncoderDecoderRetrievalModel, RetrievalConfig
    from rqvae_tpu_torch.utils.checkpoint_sharded import load_checkpoint_sharded, save_checkpoint_sharded

    cfg = RetrievalConfig(**sc["config"])
    model = EncoderDecoderRetrievalModel(cfg, device="cpu", seed=4)
    opt = _optimizer(model.parameters(), sc["opt"])
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    path = save_checkpoint_sharded(sc["dir"], 5, model.state_dict(), opt.state_dict(), cfg)
    template = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    with_template = load_checkpoint_sharded(path, template, {"count": 0, "mu": [torch.zeros_like(m) for m in opt.mu],
                                                             "nu": [torch.zeros_like(m) for m in opt.nu]})
    bare = load_checkpoint_sharded(path)
    return {"path": path, "saved": {"params": model.state_dict(), "opt_state": opt.state_dict()},
            "with_template": with_template, "bare": bare}


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


def cli(sc: dict, replicas) -> dict:
    """A trainer's command line, `main(argv)` of train_decoder (stage 2) or
    train_rqvae (stage 1). Returns the run's summary and, for each step
    runner it made, whether the runner holds a CUDA graph."""
    from rqvae_tpu_torch.train import train_decoder, train_rqvae

    module, factory = ((train_decoder, "make_decoder_graph_train_step") if sc["stage"] == 2
                       else (train_rqvae, "make_rqvae_graph_train_step"))
    make, run, runners, summaries = getattr(module, factory), module.train, [], []

    def making(*args, **kwargs):
        runners.append(make(*args, **kwargs))
        return runners[-1]

    @functools.wraps(run)  # the config reads the trainer's signature
    def train(*args, **kwargs):
        summaries.append(run(*args, **kwargs))
        return summaries[-1]

    setattr(module, factory, making)
    module.train = train
    try:
        module.main(sc["argv"])
    finally:
        setattr(module, factory, make)
        module.train = run
    return {"summary": summaries[-1], "graphs": [s.chunks.graph is not None for s in runners]}


@contextlib.contextmanager
def _recorded(sc: dict, rank: int):
    """While a scenario runs: the kernel wrappers' launch counters start from
    zero, each launch of kernels 4 and 5 has its (b0, h0, heads_total)
    recorded, and rank 1 carries the fault `sc["fault"]`, if any:
    "dropout_rows_from_0", its data-parallel forwards draw dropout masks
    from global row 0, as rank 0's do; "grads_left_out", its gradients enter
    the all-reduce as zeros, so the mean holds rank 0's alone;
    "heads_from_0", kernels 4 and 5 draw the masks of heads 0.. in place of
    its own. Either way the ranks stay bit-equal and the run completes.
    Yields the dict that receives "launches" and "attention_calls"."""
    from rqvae_tpu_torch.ops.cuda import attention as A
    from rqvae_tpu_torch.ops.cuda.decoder_stack import t5_decoder_stack_infer
    from rqvae_tpu_torch.ops.cuda.encoder_stack import t5_encoder_stack_infer
    from rqvae_tpu_torch.ops.cuda.hash_dropout import hash_dropout_cuda
    from rqvae_tpu_torch.ops.cuda.rq_encode import fused_encode_quantize
    from rqvae_tpu_torch.parallel import dist
    from rqvae_tpu_torch.train import decoder_steps

    wrappers = {"rq_encode": fused_encode_quantize, "decoder_stack": t5_decoder_stack_infer,
                "encoder_stack": t5_encoder_stack_infer, "attention": A.t5_attention, "hash_dropout": hash_dropout_cuda}
    for fn in wrappers.values():
        fn.launches = 0
    A.t5_attention.backward_launches = 0
    fault = sc.get("fault") if rank == 1 else None
    calls = set()
    saved = [(A, "_forward_cuda", A._forward_cuda), (A, "_backward_cuda", A._backward_cuda),
             (decoder_steps, "_rank_seeds", decoder_steps._rank_seeds),
             (dist.Replicas, "average_step_", dist.Replicas.average_step_)]
    fwd, bwd, rank_seeds, average = (v for _, _, v in saved)

    def recording(kernel):
        def launch(*args, b0=0, h0=0, heads_total=None, **kwargs):
            h0 = 0 if fault == "heads_from_0" else h0
            calls.add((kernel.__name__, int(b0), int(h0), heads_total))
            return kernel(*args, b0=b0, h0=h0, heads_total=heads_total, **kwargs)
        return launch

    def rows_from_0(seeds, replicas, rows):
        out = rank_seeds(seeds, replicas, rows)
        return out if out is None or replicas is None else out._replace(b0=0)

    def left_out(self, params, metrics, exact=()):
        for p in params:
            if p.grad is not None:
                p.grad.zero_()
        return average(self, params, metrics, exact)

    A._forward_cuda, A._backward_cuda = recording(fwd), recording(bwd)
    if fault == "dropout_rows_from_0":
        decoder_steps._rank_seeds = rows_from_0
    elif fault == "grads_left_out":
        dist.Replicas.average_step_ = left_out
    elif fault not in (None, "heads_from_0"):
        raise ValueError(f"no planted fault {fault!r}")
    seen = {}
    try:
        yield seen
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)
    seen["launches"] = {**{name: fn.launches for name, fn in wrappers.items()},
                        "attention_bwd": A.t5_attention.backward_launches}
    seen["attention_calls"] = sorted(calls, key=str)


def main(spec_path: str) -> None:
    import torch

    torch.set_num_threads(1)
    from rqvae_tpu_torch.parallel import dist

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = dist.initialize_distributed(spec.get("device", "cpu"))
    replicas = dist.replicas()
    run = {"decoder_step": decoder_step, "decoder_graph": decoder_graph, "rqvae_step": rqvae_step,
           "train_decoder": trainer, "train_rqvae": trainer, "tp_step": tp_step,
           "ckpt_sharded": ckpt_sharded, "cli": cli}
    for sc in spec["scenarios"]:
        with _recorded(sc, dist.process_index()) as seen:
            result = run[sc["kind"]](sc, replicas)
        torch.save({**result, **seen}, os.path.join(spec["out"], f"{sc['name']}.rank{dist.process_index()}.pt"))
    print(json.dumps({"rank": dist.process_index(), "world": dist.process_count(), "backend": backend,
                      "done": [sc["name"] for sc in spec["scenarios"]]}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main(sys.argv[1])
