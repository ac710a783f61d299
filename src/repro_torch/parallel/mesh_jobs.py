"""Jobs on the ranks of a mesh: the collectives (and a norm over a cut
row), gpipe, the MoE's mesh paths, FSDP training and the serving steps
on a rank's shards.

The rank side of chip_smoke.py's phases 10a–10d and of the CPU tests of
the mesh paths (tests/test_torch_sharding.py, test_torch_pipeline.py,
test_torch_moe_mesh.py, test_torch_fsdp.py, test_torch_tp_serve.py); it
imports no JAX. Each job
is a dataclass the caller pickles to ``repro_torch.parallel.launch.spawn``;
its function runs on every rank over a ``sharding.Mesh`` of the spawned
group and returns host results (numpy arrays, numbers)::

    out = launch.spawn(pipeline_job, 4, (job,), store_dir=tmp,
                       backend="gloo")

``device`` is every rank's (``"cuda:0"``: gloo ranks sharing the one
card). Run as a script, it probes which collectives gloo takes for CUDA
tensors on the card (:func:`probe_job`)::

    PYTHONPATH=src python -m repro_torch.parallel.mesh_jobs
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import itertools
import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _zero_launches():
    from repro_torch import kernels
    for k in kernels.wrappers().values():
        k.launches = 0


def _launches() -> int:
    from repro_torch import kernels
    return sum(k.launches for k in kernels.wrappers().values())


@contextlib.contextmanager
def attention_launches():
    """Count both dense attention kernels' launches inside the block, from
    0, by the mixer kind of the layer that made them: ``"cross"`` inside
    ``attention.cross_forward``, ``"enc"`` inside ``encoder_forward`` and
    ``"recurrent"`` inside ``transformer.recurrent_forward`` (each wrapped
    for the block alone, each call's launches the difference of the
    counters), ``"gqa"`` the rest. Yields a dict filled
    at the block's end: ``"total"`` {kernel: launches} and ``"by_mixer"``
    {(mixer, kernel): launches} of those launched."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention, transformer
    kernels = {"flash_attention": fa.flash_attention,
               "flash_decode": da.flash_decode}
    by_mixer: Dict[Tuple[str, str], int] = collections.Counter()

    def counted(mixer, fn):
        def call(*args, **kw):
            before = {k: w.launches for k, w in kernels.items()}
            try:
                return fn(*args, **kw)
            finally:
                for k, w in kernels.items():
                    by_mixer[(mixer, k)] += w.launches - before[k]
        return call

    saved = (attention.cross_forward, attention.encoder_forward,
             transformer.recurrent_forward)
    for w in kernels.values():
        w.launches = 0
    attention.cross_forward = counted("cross", saved[0])
    attention.encoder_forward = counted("enc", saved[1])
    transformer.recurrent_forward = counted("recurrent", saved[2])
    counts: Dict[str, Any] = {}
    try:
        yield counts
    finally:
        (attention.cross_forward, attention.encoder_forward,
         transformer.recurrent_forward) = saved
    total = {k: w.launches for k, w in kernels.items()}
    for k in kernels:
        by_mixer[("gqa", k)] = total[k] - sum(
            by_mixer[(m, k)] for m in ("cross", "enc", "recurrent"))
    counts.update(total=total, by_mixer=dict(+by_mixer))


def _host(t: Optional[torch.Tensor]):
    return None if t is None else t.detach().float().cpu().numpy()


def fingerprint(t: torch.Tensor, chunk: int = 1 << 24
                ) -> Tuple[float, float, float]:
    """(Σx, Σ|x|, Σx²) of a tensor in f64 (``FsdpJob``'s ``sums``),
    summed over slices of its first dimension of about ``chunk`` elements,
    so that the f64 copies stay small beside a large leaf (ranks sharing
    one card hold little spare memory after a step)."""
    x = t.detach()
    if x.dim() == 0:
        x = x.reshape(1)
    rows = max(1, chunk // max(1, x.numel() // max(1, x.shape[0])))
    acc = torch.zeros(3, dtype=torch.float64, device=x.device)
    for c in x.split(rows):
        c = c.double()
        acc += torch.stack((c.sum(), c.abs().sum(), (c * c).sum()))
    s, a, q = acc.tolist()
    return s, a, q


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    return device


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def each(rank: int, fn, jobs: Sequence[Any]) -> List[Any]:
    """``fn(rank, job)`` for each job in turn: a file's cases in one
    spawn (``fn`` one of this module's jobs)."""
    return [fn(rank, job) for job in jobs]


def run_jobs(rank: int, calls: Sequence[Tuple[Any, Any]]) -> List[Any]:
    """``fn(rank, job)`` for each ``(fn, job)`` of ``calls`` in turn: jobs
    of several kinds in one spawn."""
    return [fn(rank, job) for fn, job in calls]


def _mesh(shape: Sequence[int], names: Sequence[str]):
    from repro_torch.parallel import sharding
    return sharding.Mesh(shape, names)


# --------------------------------------------------------------------------
# the collectives, forward and backward, against their plain meaning
# --------------------------------------------------------------------------
@dataclasses.dataclass
class CollectivesJob:
    shape: Tuple[int, ...] = (2, 2)
    names: Tuple[str, ...] = ("data", "model")
    device: str = "cpu"


def _value(rank: int, shape, device, dtype=torch.float32) -> torch.Tensor:
    """A rank's input: distinct per rank, exact in bf16 and f32."""
    n = math.prod(shape)
    v = (torch.arange(n, dtype=torch.float64) % 7 - 3) * 0.25 + rank
    return v.reshape(shape).to(dtype).to(device)


def collectives_job(rank: int, job: CollectivesJob) -> Dict[str, Any]:
    """Each collective of parallel/sharding.py over every line of the
    mesh, its forward and its backward held against what it means (the
    other ranks' inputs are known functions of their ranks); returns the
    names of the checks that failed (none is the pass) and the line
    layout."""
    from repro_torch.parallel import sharding as sh
    device = _device(job.device)
    mesh = _mesh(job.shape, job.names)
    bad: List[str] = []

    def check(name, got, want):
        if not torch.equal(got.cpu(), want.cpu()):
            bad.append(f"{name}: {got.flatten()[:4].tolist()} vs "
                       f"{want.flatten()[:4].tolist()}")

    lines = {}
    for n in range(1, len(job.names) + 1):
        for axes in itertools.combinations(job.names, n):
            line = mesh.line(axes)
            lines[axes] = (line.size, line.index, line.ranks)
            if line.size == 1:
                continue
            S, i = line.size, line.index
            tag = "/".join(axes)
            for dt in (torch.float32, torch.bfloat16):
                x = _value(rank, (2 * S, 3), device, dt).requires_grad_(True)
                vals = [_value(r, (2 * S, 3), device, dt) for r in line.ranks]
                # reduce_from: Σ in f32, cotangent passed through
                y = sh.reduce_from(x, line)
                check(f"reduce_from {tag} {dt}", y, torch.stack(
                    [v.float() for v in vals]).sum(0).to(dt))
                y.backward(torch.ones_like(y) * (i + 1))
                check(f"reduce_from' {tag} {dt}", x.grad,
                      torch.ones_like(x) * (i + 1))
                x.grad = None
                # copy_to: identity, cotangents summed
                y = sh.copy_to(x, line)
                y.backward(torch.ones_like(y) * (i + 1))
                check(f"copy_to' {tag} {dt}", x.grad, torch.full_like(
                    x, sum(range(1, S + 1))))
                x.grad = None
                # gather_from / split_to along dim 0
                y = sh.gather_from(x, line, 0)
                check(f"gather_from {tag} {dt}", y, torch.cat(vals))
                g = torch.arange(y.numel(), dtype=dt,
                                 device=device).reshape(y.shape)
                y.backward(g)
                check(f"gather_from' {tag} {dt}", x.grad,
                      g.chunk(S)[i])
                x.grad = None
                y = sh.split_to(x, line, 1 if x.shape[1] % S == 0 else 0)
                dim = 1 if x.shape[1] % S == 0 else 0
                check(f"split_to {tag} {dt}", y, x.detach().chunk(S, dim)[i])
                y.backward(torch.ones_like(y) * (i + 1))
                check(f"split_to' {tag} {dt}", x.grad, torch.cat(
                    [torch.ones_like(y) * (r + 1) for r in range(S)], dim))
                x.grad = None
                # gather_shards: backward reduce-scatters the sum
                y = sh.gather_shards(x, line, 0)
                check(f"gather_shards {tag} {dt}", y, torch.cat(vals))
                y.backward(torch.ones_like(y) * (i + 1))
                check(f"gather_shards' {tag} {dt}", x.grad, torch.full_like(
                    x, sum(range(1, S + 1))))
                x.grad = None
                # all_to_all: part j to rank j; backward the way back
                y = sh.all_to_all(x, line)
                check(f"all_to_all {tag} {dt}", y,
                      torch.cat([v.chunk(S)[i] for v in vals]))
                y.backward(y.detach())
                check(f"all_to_all' {tag} {dt}", x.grad, x.detach())
                x.grad = None
                # ring_shift by 1 and back
                y = sh.ring_shift(x, line, 1)
                check(f"ring_shift {tag} {dt}", y, vals[(i - 1) % S])
                y.backward(y.detach() * 2)
                check(f"ring_shift' {tag} {dt}", x.grad, x.detach() * 2)
                x.grad = None
            # pmean: the mean; backward the mean of the cotangents / rep
            x = _value(rank, (3,), device).requires_grad_(True)
            y = sh.pmean(x, line, replicated=2)
            want = torch.stack([_value(r, (3,), device)
                                for r in line.ranks]).mean(0)
            if not torch.allclose(y, want, rtol=0, atol=1e-6):
                bad.append(f"pmean {tag}")
            y.backward(torch.full_like(y, float(i)))
            if not torch.allclose(x.grad, torch.full_like(
                    x, (S - 1) / 2 / 2), rtol=0, atol=1e-6):
                bad.append(f"pmean' {tag}")
    # gather_leaf / shard_of round trip on a (data, model)-bound spec
    spec = (tuple(job.names), None)
    whole = _value(0, (4 * mesh.size, 3), device)
    part = sh.shard_of(whole, spec, mesh)
    check("gather_leaf", sh.gather_leaf(part, spec, mesh), whole)
    return {"bad": bad, "lines": lines, "coords": mesh.coords()}


@dataclasses.dataclass
class NormJob:
    """``blocks.rms_norm`` of rows ``x`` [N, d] by ``scale`` [d] with the
    channels cut over the ``model`` line of a (data, model) ``mesh``, and
    the backward of Σ(y · ``cot``) (numpy, whole: each rank takes its
    equal part of the channels)."""
    x: np.ndarray
    scale: np.ndarray
    cot: np.ndarray
    mesh: Tuple[int, int] = (2, 2)


def norm_job(rank: int, job: NormJob) -> Dict[str, Any]:
    """The rank's part of y and the gradients of its parts of x and of the
    scale (host f32), and its coordinates."""
    from repro_torch.models import blocks
    from repro_torch.parallel import sharding as sh
    mesh = _mesh(job.mesh, ("data", "model"))
    line = mesh.line("model")
    n = job.x.shape[-1] // line.size
    part = slice(line.index * n, (line.index + 1) * n)
    x, scale = (torch.from_numpy(np.array(a[..., part])).requires_grad_(True)
                for a in (job.x, job.scale))
    y = blocks.rms_norm(scale, x, line=line)
    (y * torch.from_numpy(np.array(job.cot[..., part]))).sum().backward()
    return {"coords": mesh.coords(), "y": _host(y), "dx": _host(x.grad),
            "dscale": _host(scale.grad)}


# --------------------------------------------------------------------------
# gpipe
# --------------------------------------------------------------------------
@dataclasses.dataclass
class PipelineJob:
    """``ws`` [n_layers, D, D] and ``xs`` [M, mb, D] numpy: the reference
    test's ``tanh(x @ w)`` layers; or ``arch``: that arch's decoder layers
    at full width (``smoke``: its smoke config's, ``n_layers`` of them;
    bf16, drawn from ``seed`` on the device, the no-cache training layer
    as ``layer_fn``) over ``micro`` microbatches of ``rows`` × ``seq``
    hidden states drawn from ``seed + 1``."""
    stages: int
    n_layers: int
    ws: Optional[np.ndarray] = None
    xs: Optional[np.ndarray] = None
    arch: Optional[str] = None
    smoke: bool = False
    seed: int = 0
    micro: int = 8
    rows: int = 1
    seq: int = 1024
    device: str = "cpu"


def pipeline_layers(job: PipelineJob, device: torch.device):
    """(the stacked layers of the whole model as a tree of [n_layers, ...]
    leaves, layer_fn, xs): the same on every rank and in the caller's
    sequential reference."""
    if job.arch is None:
        ws = torch.from_numpy(job.ws).to(device)
        return ({"w": ws}, lambda p, x: torch.tanh(x @ p["w"]),
                torch.from_numpy(job.xs).to(device))
    from repro_torch import configs
    from repro_torch.models import transformer
    get = configs.get_smoke_config if job.smoke else configs.get_config
    cfg = get(job.arch, param_dtype=torch.bfloat16)
    (pattern, count), = cfg.groups
    (kind,) = pattern
    if job.smoke:
        cfg = dataclasses.replace(cfg, groups=((pattern, job.n_layers),))
    elif count != job.n_layers:
        raise ValueError(f"{job.arch} has {count} layers")
    gen = torch.Generator(device=device).manual_seed(job.seed)
    stack = transformer.init_model(cfg, gen, device).groups[0][0]
    layers = {k: v.detach() for k, v in _flat(stack.tree()).items()}
    positions = torch.arange(job.seq, device=device)[None].expand(
        job.rows, job.seq)

    def layer_fn(p, x):
        return transformer._train_layer(kind, _nest(p), x, positions, None,
                                        cfg, None)[0]
    gen = torch.Generator(device=device).manual_seed(job.seed + 1)
    xs = torch.randn((job.micro, job.rows, job.seq, cfg.d_model),
                     generator=gen, device=device).to(torch.bfloat16)
    return layers, layer_fn, xs


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _nest(flat):
    out: Dict[str, Any] = {}
    for k, v in flat.items():
        *heads, leaf = k.split(".")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = v
    return out


def pipeline_job(rank: int, job: PipelineJob) -> Dict[str, Any]:
    """gpipe forward and the backward of ``ys.float().sum()``: the
    outputs, the inputs' gradient and this stage's layers' gradients (host
    f32), with the ticks, the launches of the kernels and the wall
    time."""
    from repro_torch.parallel import pipeline
    device = _device(job.device)
    mesh = _mesh((job.stages,), ("stage",))
    layers, layer_fn, xs = pipeline_layers(job, device)
    per = job.n_layers // job.stages
    s = mesh.coords()["stage"]
    mine = {k: v[s * per:(s + 1) * per].clone().requires_grad_(True)
            for k, v in layers.items()}
    del layers
    xs = xs.clone().requires_grad_(True)
    apply = pipeline.gpipe(layer_fn, mesh, "stage", job.n_layers)
    _zero_launches()
    _sync(device)
    t0 = time.perf_counter()
    ys = apply(mine, xs)
    ys.float().sum().backward()
    _sync(device)
    wall = time.perf_counter() - t0
    return {"stage": s, "ys": _host(ys), "x_grad": _host(xs.grad),
            "w_grads": {k: _host(v.grad) for k, v in mine.items()},
            "ticks": xs.shape[0] + job.stages - 1,
            "launches": _launches(), "wall_s": wall,
            "peak_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                         if device.type == "cuda" else None)}


def sequential(job: PipelineJob, device) -> Dict[str, Any]:
    """The reference for :func:`pipeline_job`: the same layers applied in
    order to each microbatch, and the backward of the same sum."""
    layers, layer_fn, xs = pipeline_layers(job, device)
    layers = {k: v.clone().requires_grad_(True) for k, v in layers.items()}
    xs = xs.clone().requires_grad_(True)
    outs = []
    for m in range(xs.shape[0]):
        h = xs[m]
        for i in range(job.n_layers):
            h = layer_fn({k: v[i] for k, v in layers.items()}, h)
        outs.append(h)
    ys = torch.stack(outs)
    ys.float().sum().backward()
    return {"ys": _host(ys), "x_grad": _host(xs.grad),
            "w_grads": {k: _host(v.grad) for k, v in layers.items()}}


# --------------------------------------------------------------------------
# the MoE's mesh paths
# --------------------------------------------------------------------------
@dataclasses.dataclass
class MoeJob:
    """One MoE layer on a (data, model) mesh. ``weights``: the reference
    tree as numpy (``router``, ``w_gate``, ``w_up``, ``w_down``,
    ``shared``), each rank keeping its EP shard of the experts; or None:
    :func:`draw_moe` from ``seed``, each rank drawing only its experts.
    ``x``: the global input [B, L, d] (numpy), or None: ``tokens`` = (B,
    L) rows drawn from ``seed + 1`` on the device. ``r``: a cotangent for
    y (numpy [B, L, d]) to take the gradients of Σ y·r and of aux (each
    rank then returns them); None: the forward alone."""
    cfg: Any
    mesh: Tuple[int, int]
    weights: Optional[Dict[str, Any]] = None
    x: Optional[np.ndarray] = None
    r: Optional[np.ndarray] = None
    seed: int = 0
    tokens: Tuple[int, int] = (8, 256)
    dtype: Any = torch.float32
    device: str = "cpu"


def ep_experts(cfg, model: int) -> Tuple[bool, int]:
    """(the EP path applies, experts a rank holds) at ``model`` ranks."""
    ep = cfg.ep and cfg.n_experts % model == 0
    return ep, cfg.n_experts // model if ep else cfg.n_experts


def draw_moe(cfg, lo: int, n: int, seed: int, device, dtype
             ) -> Dict[str, Any]:
    """A MoE layer's leaves with experts ``[lo, lo + n)`` only, each
    expert drawn from its own generator (seed, e), so any slice of the
    experts is the same slice of the whole layer: N(0, 1/E) experts (the
    reference's ``dense_init`` fan-in is the expert axis), the router
    N(0, 1/d) in f32, the shared experts N(0, 1/fan_in)."""
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff

    def normal(shape, std, g, dt):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        return w.normal_(0.0, 1.0, generator=g).mul_(std).to(dt)

    def gen(k):
        return torch.Generator(device=device).manual_seed(
            seed * 1_000_003 + k)

    p = {"router": normal((d, E), d ** -0.5, gen(E), torch.float32)}
    for j, (name, shape) in enumerate((("w_gate", (d, f)), ("w_up", (d, f)),
                                       ("w_down", (f, d)))):
        p[name] = torch.empty((n,) + shape, dtype=dtype, device=device)
        for e in range(lo, lo + n):
            p[name][e - lo] = normal(shape, E ** -0.5, gen(E + 1 + 3 * e + j),
                                     dtype)
    if cfg.n_shared:
        fs, g = f * cfg.n_shared, gen(4 * E + 1)
        p["shared"] = {"w_gate": normal((d, fs), d ** -0.5, g, dtype),
                       "w_up": normal((d, fs), d ** -0.5, g, dtype),
                       "w_down": normal((fs, d), fs ** -0.5, g, dtype)}
    return p


def moe_input(job: MoeJob, device) -> torch.Tensor:
    if job.x is not None:
        return torch.from_numpy(job.x).to(device).to(job.dtype)
    gen = torch.Generator(device=device).manual_seed(job.seed + 1)
    return torch.randn(job.tokens + (job.cfg.d_model,), generator=gen,
                       device=device).to(job.dtype)


def moe_job(rank: int, job: MoeJob) -> Dict[str, Any]:
    """``moe_forward`` under the mesh on this rank's rows: y and aux, the
    capacity drops of the routing this rank ran, and with ``job.r`` the
    gradients of Σ y·r (summed over the data ranks) and of aux (their
    mean): x's (this rank's rows), the router's, the shared experts' and
    the experts' (this rank's EP shard)."""
    from repro_torch.models import moe
    from repro_torch.parallel import sharding as sh
    device = _device(job.device)
    cfg = job.cfg
    D, M = job.mesh
    mesh = _mesh(job.mesh, ("data", "model"))
    c = mesh.coords()
    ep, held = ep_experts(cfg, M)
    lo = c["model"] * held if ep else 0
    if job.weights is None:
        p = draw_moe(cfg, lo, held, job.seed, device, job.dtype)
    else:
        w = job.weights
        p = {k: torch.from_numpy(np.array(w[k])).to(device)
             for k in ("router", "w_gate", "w_up", "w_down")}
        for k in ("w_gate", "w_up", "w_down"):
            p[k] = p[k][lo:lo + held].to(job.dtype)
        if "shared" in w:
            p["shared"] = {k: torch.from_numpy(np.array(v)).to(device).to(
                job.dtype) for k, v in w["shared"].items()}
    x = moe_input(job, device)
    B, L, d = x.shape
    rows = slice(c["data"] * B // D, (c["data"] + 1) * B // D)
    x = x[rows].clone().requires_grad_(job.r is not None)
    leaves = [p["router"], p["w_gate"], p["w_up"], p["w_down"]] + (
        list(p["shared"].values()) if "shared" in p else [])
    for t in leaves:
        t.requires_grad_(job.r is not None)
    a2a = cfg.dispatch == "a2a" and ep and L % M == 0
    with torch.no_grad():    # the routing this rank runs, for its drops
        xr = x[:, c["model"] * L // M:(c["model"] + 1) * L // M] if a2a \
            else x
        gates, idx, _ = moe.route(p["router"], xr.reshape(-1, d), cfg)
        sel = moe.select(gates, idx, cfg)
        drops = (int(moe.dropped(idx, *sel[1:], cfg.n_experts)), idx.numel())
    _zero_launches()
    _sync(device)
    t0 = time.perf_counter()
    with sh.use_mesh(mesh), torch.set_grad_enabled(job.r is not None):
        y, aux = moe.moe_forward(p, x, cfg)
    _sync(device)
    out = {"coords": c, "y": _host(y), "aux": float(aux.detach()),
           "drops": drops,
           "path": "a2a" if a2a else ("ep" if ep else "slot"),
           "wall_s": time.perf_counter() - t0, "launches": _launches()}
    if job.r is None:
        return out
    data = mesh.line("data")
    r = torch.from_numpy(job.r[rows]).to(device).to(y.dtype)
    names = ["router", "w_gate", "w_up", "w_down"] + (
        [f"shared.{k}" for k in p["shared"]] if "shared" in p else [])
    for what, loss, scale in (("y", (y.float() * r.float()).sum(), 1),
                              ("aux", aux, D)):
        for t in leaves + [x]:
            t.grad = None
        loss.backward(retain_graph=what == "y")
        with torch.no_grad():
            out[f"grads_{what}"] = {
                n: _host(sh.reduce_from(torch.zeros_like(t) if t.grad is None
                                        else t.grad, data) / scale)
                for n, t in zip(names, leaves)}
            out[f"grads_{what}"]["x"] = _host(x.grad)
    return out


# --------------------------------------------------------------------------
# FSDP training
# --------------------------------------------------------------------------
@dataclasses.dataclass
class FsdpJob:
    """Train steps of ``cfg`` on a mesh of the spawned ranks: ``mesh``
    (data, model) under the rules ``rules`` (overrides on
    ``DEFAULT_RULES``), or None: (ranks, 1), the FSDP layout.
    ``weights``: the reference tree as numpy, or None: each rank draws
    its shards of the model ``seed`` gives (launch/train.py
    ``build_state``'s values), a piece of each leaf at a time
    (train/step.py ``init_shards``: no whole leaf on the device).
    ``batches`` (global numpy batches, one a step), ``grad_accum``,
    ``compress``, ``opt`` (an ``optim/adamw.Config``; None: its
    defaults). ``save_dir``: rank 0 saves the whole state there after
    the steps (step = number of steps; every rank waits for the save, so
    that a later job of the spawn may restore it); ``restore_dir``: the
    state is restored from that directory's newest checkpoint before the
    steps, each rank taking its slice. ``wholes``: rank 0 returns the
    whole state before the steps and after each (False: none, for a
    model too large to carry back); ``shards``: every rank returns its
    own shards of the state (train/step.py ``state_tree``'s leaves)
    before the steps and after each; ``sums``: every rank returns, for
    each of those leaves, its shard's (Σx, Σ|x|, Σx²) in f64 before the
    steps and after each (a fingerprint of shards too large to carry
    back)."""
    cfg: Any
    weights: Any
    batches: List[Dict[str, np.ndarray]]
    grad_accum: int = 1
    compress: Optional[str] = None
    save_dir: Optional[str] = None
    restore_dir: Optional[str] = None
    device: str = "cpu"
    mesh: Optional[Tuple[int, int]] = None
    rules: Optional[Dict[str, Any]] = None
    wholes: bool = True
    shards: bool = False
    sums: bool = False
    seed: int = 0
    opt: Any = None


def fsdp_job(rank: int, job: FsdpJob) -> Dict[str, Any]:
    """The steps' metrics (global means, every rank alike) and times (and
    the set-up's before them), this rank's coordinates, shard shapes, peak
    memory on the card (allocated and reserved) and kernel launches, on rank 0 the whole state
    (the reference's tree of host leaves) before the steps and after
    each, and this rank's ``shards`` / ``sums`` where the job asks."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import tree as tree_lib
    from repro_torch.data import pipeline as dp
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import adamw
    from repro_torch.parallel import compression, sharding
    from repro_torch.train import step as step_lib
    t0 = time.perf_counter()
    device = _device(job.device)
    mesh = make_dev_mesh() if job.mesh is None else _mesh(
        job.mesh, ("data", "model"))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out: Dict[str, Any] = {"coords": mesh.coords()}
    with sharding.use_mesh(mesh, job.rules):
        if job.weights is None:
            state = step_lib.init_state(step_lib.init_shards(
                job.cfg, mesh, torch.Generator(device=device).manual_seed(
                    job.seed), device))
        else:
            state = step_lib.shard_state(step_lib.init_state(
                params_from_numpy(job.weights, job.cfg, device)), mesh)
        if job.restore_dir is not None:
            host, _ = CheckpointManager(job.restore_dir).restore(
                step_lib.state_tree(state),
                shardings=step_lib.state_shardings(state))
            step_lib.load_state(state, host)
        ts = step_lib.make_train_step(
            job.cfg, job.opt or adamw.Config(), grad_accum=job.grad_accum,
            compressor=job.compress and compression.Compressor(
                mode=job.compress))
        keep = job.wholes and mesh.rank == 0
        metrics, step_s = [], []
        wholes = [step_lib.whole_state(state, keep=keep)] if job.wholes \
            else []

        def own():
            leaves = tree_lib.leaves(step_lib.state_tree(state))
            if job.shards:
                shards.append([tree_lib.to_host(t) for t in leaves])
            if job.sums:
                sums.append([fingerprint(t) for t in leaves])
        shards, sums = [], []
        own()
        out["setup_s"] = time.perf_counter() - t0
        _zero_launches()
        for b in job.batches:
            rows = dp.to_device(step_lib.rank_rows(b, job.grad_accum, mesh),
                                device)
            _sync(device)
            t0 = time.perf_counter()
            state, m = ts(state, rows)
            metrics.append({k: float(v) for k, v in m.items()})
            _sync(device)
            step_s.append(time.perf_counter() - t0)
            if device.type == "cuda":   # ranks sharing the card: give back
                torch.cuda.empty_cache()    # the step's freed blocks
            if job.wholes:
                wholes.append(step_lib.whole_state(state, keep=keep))
            own()
        if job.save_dir is not None:
            saved = wholes[-1] if job.wholes else step_lib.whole_state(
                state, keep=mesh.rank == 0)
            if mesh.rank == 0:
                CheckpointManager(job.save_dir).save(
                    len(job.batches), saved,
                    extra={"data_step": len(job.batches)})
            if torch.distributed.is_initialized():
                torch.distributed.barrier()
    shapes = [tuple(t.shape) for t in tree_lib.leaves(
        step_lib.state_tree(state).params)]
    peak, reserved = (torch.cuda.max_memory_allocated(device) / 2**30,
                      torch.cuda.max_memory_reserved(device) / 2**30) \
        if device.type == "cuda" else (None, None)
    del state, ts
    if device.type == "cuda":       # the next job of the spawn starts empty
        torch.cuda.empty_cache()
    return dict(out, metrics=metrics, shapes=shapes, step_s=step_s,
                launches=_launches(),
                shards=shards if job.shards else None,
                sums=sums if job.sums else None,
                wholes=wholes if job.wholes and mesh.rank == 0 else None,
                peak_gib=peak, reserved_gib=reserved)


def digest(arrays) -> str:
    """One hash of a sequence of arrays' bytes, dtypes and shapes."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class TrainJob:
    """launch/train.py ``train`` on a (ranks, 1) mesh: ``kwargs`` as
    ``train``'s (``f32``: the smoke config at f32 compute, as the CPU
    tests run it); the ranks return their losses, grad norms, peak
    memory and kernel launches, and a digest of their state shards after
    the run."""
    kwargs: Dict[str, Any]
    f32: bool = False


def train_job(rank: int, job: TrainJob) -> Dict[str, Any]:
    from repro_torch.core import tree as tree_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.train import step as step_lib
    device = _device(job.kwargs.get("device", "cpu"))
    mesh = make_dev_mesh()
    if job.f32:
        smoke = train_lib.configs.get_smoke_config
        train_lib.configs.get_smoke_config = \
            lambda arch: smoke(arch, compute_dtype=torch.float32)
    rows: List[Dict[str, float]] = []
    states = []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _zero_launches()
    t0 = time.perf_counter()

    def on_step(step, loss, seconds, state, metrics):
        rows.append({"step": step, "loss": loss, "s": seconds,
                     "grad_norm": float(metrics["grad_norm"])})
        states[:] = [state]

    losses = train_lib.train(**job.kwargs, on_step=on_step, mesh=mesh)
    wall = time.perf_counter() - t0
    shards = [tree_lib.to_host(t) for t in tree_lib.leaves(
        step_lib.state_tree(states[-1]))] if states else []
    return {"losses": losses, "steps": rows, "wall_s": wall,
            "launches": _launches(), "digest": digest(shards),
            "peak_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                         if device.type == "cuda" else None),
            "coords": mesh.coords()}


# --------------------------------------------------------------------------
# the serving steps on a rank's shards
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ServeJob:
    """train/step.py's prefill and decode steps of ``cfg`` on a (data,
    model) mesh under the rules ``rules`` (overrides on ``DEFAULT_RULES``),
    over ``batch`` slots × ``max_seq`` rows. ``weights``: the reference
    tree as numpy (each rank cuts its shard on the host), or None: the
    whole model drawn from ``seed`` on the device, then cut. The whole
    caches start as ``caches`` (numpy leaves in ``init_caches``' order),
    or with ``fill`` as N(0, 1) draws from ``seed + 2`` (a decode step
    over a full cache with no prefill first), else zeros. ``prompt``:
    global tokens [B, L] for a prefill (None: none), with ``extra`` a
    cross-attention model's global encoder input [B, S_enc, kv_dim]
    (numpy; cast to the compute dtype; each rank takes its rows);
    ``decode``: then each (tokens [B, 1], cache_pos: an int or a [B]
    array) in turn.
    ``compare``: each rank also runs the one-rank steps here, on the whole
    model and caches, and reports its rows' and its cache parts'
    differences from them; ``keep``: what each rank returns as host arrays
    (``"logits"``, its rows of each step's; ``"caches"``, its parts). With
    ``weights`` None a rank draws its shards alone (train/step.py
    ``init_shards``: the values of the whole draw, which ``compare``
    draws besides)."""
    cfg: Any
    mesh: Tuple[int, int]
    rules: Dict[str, Any]
    batch: int
    max_seq: int
    prompt: Optional[np.ndarray] = None
    extra: Optional[np.ndarray] = None
    decode: Sequence[Tuple[np.ndarray, Any]] = ()
    weights: Any = None
    fill: bool = False
    caches: Optional[Sequence[np.ndarray]] = None
    seed: int = 0
    device: str = "cpu"
    compare: bool = False
    keep: Tuple[str, ...] = ("logits", "caches")


def _whole_model(job: ServeJob, device):
    from repro_torch.models import convert, transformer
    if job.weights is not None:
        return convert.params_from_numpy(job.weights, job.cfg, device)
    gen = torch.Generator(device=device).manual_seed(job.seed)
    return transformer.init_model(job.cfg, gen, device)


def _whole_caches(job: ServeJob, device):
    from repro_torch.core import tree as tree_lib
    from repro_torch.models import transformer
    caches = transformer.init_caches(job.cfg, job.batch, job.max_seq,
                                     device=device)
    if job.fill:
        g = torch.Generator(device=device).manual_seed(job.seed + 2)
        for a in tree_lib.leaves(caches):
            a.copy_(torch.randn(a.shape, generator=g, device=device))
    elif job.caches is not None:
        for a, c in zip(tree_lib.leaves(caches), job.caches):
            a.copy_(torch.from_numpy(np.asarray(c)))
    return caches


def one_rank(job: ServeJob, dtype=None):
    """The job's steps meshless in this process, on the whole model and
    caches it starts from; with ``dtype``, both cast to it after they are
    drawn (the same values) and the config's dtypes set to it → (each
    step's logits as f32, the final caches)."""
    from repro_torch.core import tree as tree_lib
    device = _device(job.device)
    model, caches = _whole_model(job, device), _whole_caches(job, device)
    if dtype is not None:
        model = model.to(dtype)
        caches = tree_lib.tree_map(lambda a: a.to(dtype), caches)
        job = dataclasses.replace(job, cfg=dataclasses.replace(
            job.cfg, param_dtype=dtype, compute_dtype=dtype))
    logits = _serve_steps(job, model, caches, None, device)
    return [t.float() for t in logits], caches


def _serve_steps(job: ServeJob, model, caches, specs, device,
                 rows=None) -> List[torch.Tensor]:
    """The job's prefill and decode steps on ``model`` / ``caches``;
    ``rows``: the rank's slots (tokens and positions cut to them)."""
    from repro_torch.train import step as step_lib
    tokens = lambda a: torch.from_numpy(np.asarray(a)).to(device)  # noqa
    cut = (lambda a: a) if rows is None else (lambda a: a[rows])
    out = []
    if job.prompt is not None:
        extra = None if job.extra is None else cut(torch.from_numpy(
            np.asarray(job.extra)).to(device, job.cfg.compute_dtype))
        out.append(step_lib.make_prefill_step(job.cfg, specs)(
            model, cut(tokens(job.prompt)), caches, extra)[0])
    decode = step_lib.make_decode_step(job.cfg, specs)
    for tok, pos in job.decode:
        if not isinstance(pos, int):
            pos = cut(torch.as_tensor(np.asarray(pos), device=device))
        out.append(decode(model, cut(tokens(tok)), caches, pos)[0])
    return out


def serve_job(rank: int, job: ServeJob) -> Dict[str, Any]:
    """The steps on this rank's shards: its rows' logits of each step and
    its cache parts (as ``keep`` says), the collectives it issued (kind, bytes,
    group size), the attention kernels' launches (in all and by mixer
    kind, :func:`attention_launches`), the wall time of the set-up (the
    weights and caches drawn, the one-rank steps) and of the steps, and
    with
    ``compare``, for each step, the largest difference of its logits from
    the one-rank step's on its rows, the largest one-rank logit, the
    difference's norm over the one-rank logits', both greedy tokens and
    the one-rank top-2 gap of each row; and the largest
    difference of its cache parts from the one-rank caches' and their
    largest value."""
    from repro_torch.core import tree as tree_lib
    from repro_torch.models import convert
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import step as step_lib
    t_setup = time.perf_counter()
    device = _device(job.device)
    cfg = job.cfg
    mesh = _mesh(job.mesh, ("data", "model"))
    whole_caches = _whole_caches(job, device)
    with sh.use_mesh(mesh, job.rules):
        specs = step_lib.rank_caches(cfg, job.batch, job.max_seq, mesh,
                                     device="meta")[1]
    caches = tree_lib.tree_map(lambda a, s: sh.shard_of(a, s, mesh),
                               whole_caches, specs)
    whole = _whole_model(job, device) if job.compare else None
    ref = None
    if job.compare:     # the one-rank steps, meshless, on the whole leaves
        ref = [t.float() for t in _serve_steps(job, whole, whole_caches,
                                               None, device)]
    else:
        whole_caches = None
    del whole
    if device.type == "cuda":       # for the other ranks sharing the card
        torch.cuda.empty_cache()
    with sh.use_mesh(mesh, job.rules):
        if job.weights is None:
            model = step_lib.init_shards(cfg, mesh, torch.Generator(
                device=device).manual_seed(job.seed), device)
        else:
            model = convert.rank_params_from_numpy(job.weights, cfg, mesh,
                                                   device)
        b_spec = sh.resolve(("batch", None), (job.batch, 1), mesh)
        rows = sh.shard_slices((job.batch, 1), b_spec, mesh)[0]
        _sync(device)
        t0 = time.perf_counter()
        setup = t0 - t_setup
        with sh.record_collectives() as colls, \
                attention_launches() as launches:
            got = _serve_steps(job, model, caches, specs, device, rows)
        _sync(device)
        wall = time.perf_counter() - t0
    out = {"coords": mesh.coords(), "rows": (rows.start, rows.stop),
           "setup_s": setup, "wall_s": wall, "launches": launches["total"],
           "launches_by_mixer": launches["by_mixer"],
           "collectives": [tuple(dataclasses.astuple(c)) for c in colls],
           "cache_shapes": [tuple(a.shape) for a in tree_lib.leaves(caches)]}
    if "logits" in job.keep:
        out["logits"] = [_host(t) for t in got]
    if "caches" in job.keep:
        out["caches"] = [_host(a) for a in tree_lib.leaves(caches)]
    if job.compare:     # each step: (max |diff|, max |one-rank|, the
        out["logits_vs_one"] = []     # relative norm, greedy, top-2 gap)
        for g_, r in zip(got, ref):
            r = r[rows]
            top = r.topk(2, dim=-1).values
            d = g_.float() - r
            out["logits_vs_one"].append((
                float(d.abs().max()), float(r.abs().max()),
                float(d.norm() / r.norm()), _host(g_.float().argmax(-1)),
                _host(r.argmax(-1)), _host(top[..., 0] - top[..., 1])))
        want = [sh.shard_of(a, s, mesh) for a, s in zip(
            tree_lib.leaves(whole_caches), tree_lib.leaves(
                specs, is_leaf=sh.is_spec))]
        out["caches_vs_one"] = (
            max(float((a.float() - b.float()).abs().max())
                for a, b in zip(tree_lib.leaves(caches), want)),
            max(float(b.float().abs().max()) for b in want))
        del want
    if device.type == "cuda":     # the next job of a spawn draws afresh
        del model, caches, got, whole_caches, ref
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# which collectives a backend takes on a device (a probe, not a path:
# parallel/sharding.py's collectives keep one form on every backend)
# --------------------------------------------------------------------------
PROBES = ("all_reduce f32", "all_reduce bf16", "all_gather bf16",
          "all_gather_into_tensor", "reduce_scatter_tensor",
          "all_to_all_single", "batch_isend_irecv")


def probe_job(rank: int, device: str, name: str) -> bool:
    """One collective of :data:`PROBES` on ``device`` tensors over the
    whole group; True when every rank's result is right. A backend that
    cannot take the tensor may raise, or abort the process (gloo does, on
    a CUDA pointer it writes to its socket): run each probe in a spawn of
    its own."""
    import torch.distributed as dist
    device = _device(device)
    n = dist.get_world_size()
    x = torch.full((2 * n, 3), float(rank), device=device)
    others = torch.arange(n, dtype=torch.float32, device=device)
    if name.startswith("all_reduce"):
        y = x.to(torch.bfloat16 if name.endswith("bf16") else torch.float32)
        dist.all_reduce(y)
        ok = bool((y.float() == others.sum()).all())
    elif name == "all_gather bf16":
        parts = [torch.empty_like(x, dtype=torch.bfloat16) for _ in range(n)]
        dist.all_gather(parts, x.to(torch.bfloat16))
        ok = all(bool((p.float() == r).all()) for r, p in enumerate(parts))
    elif name == "all_gather_into_tensor":
        out = torch.empty((n,) + tuple(x.shape), device=device)
        dist.all_gather_into_tensor(out, x[None])
        ok = all(bool((out[r] == r).all()) for r in range(n))
    elif name == "reduce_scatter_tensor":
        out = torch.empty((2, 3), device=device)
        dist.reduce_scatter_tensor(out, x)
        ok = bool((out == others.sum()).all())
    elif name == "all_to_all_single":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        ok = all(bool((out[2 * r:2 * r + 2] == r).all()) for r in range(n))
    else:
        out = torch.empty_like(x)
        for r in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, (rank + 1) % n),
                dist.P2POp(dist.irecv, out, (rank - 1) % n)]):
            r.wait()
        ok = bool((out == (rank - 1) % n).all())
    _sync(device)
    return ok


def main(argv: Sequence[str]) -> int:
    """Each probe of :data:`PROBES` on two gloo ranks sharing one device
    (``argv[0]``, default cuda:0), in a spawn of its own; one line each."""
    import tempfile
    from repro_torch.parallel import launch
    from repro_torch.parallel.mesh_jobs import probe_job as job  # by name
    device = argv[0] if argv else "cuda:0"
    if device.startswith("cuda") and not torch.cuda.is_available():
        print("the probe needs a CUDA device")
        return 1
    for name in PROBES:
        with tempfile.TemporaryDirectory() as store:
            try:
                ok = all(launch.spawn(job, 2, (device, name),
                                      store_dir=store, backend="gloo",
                                      timeout_s=120.0))
                said = "right" if ok else "wrong"
            except Exception as e:        # a rank raised or died
                said = f"failed: {type(e).__name__}: {str(e)[:200]}"
        print(f"probe gloo on {device}, 2 ranks, {name}: {said}", flush=True)
    return 0


if __name__ == "__main__":
    import sys
    raise SystemExit(main(sys.argv[1:]))
