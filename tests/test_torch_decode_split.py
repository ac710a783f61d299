"""The arithmetic and launch shape of the port's dense flash_decode kernel
on the H100, held against the JAX reference kernel on the CPU.

The CUDA kernel (csrc/decode_attention.cu) cannot run here, so its
arithmetic is written out below in plain PyTorch, step for step as the
kernel does it, in one launch:

  * the key axis cut into ``decode_launch``'s splits; a split stops at the
    slot's length (a length-0 slot reads no K and all of V, every logit
    NEG), and a split that starts past it leaves m = -inf, l = 0;
  * inside a split, each of the block's warps takes its own runs of keys
    (``UNROLL`` loads of the keys a warp reads at once) and keeps its own
    online softmax, one rescale per run; the warps merge once, weighing
    each by exp(m_w - max m) and leaving out warps that saw no key;
  * the block that arrives last merges every split of its rows in split
    order: weights exp(m_j - max m) (0 for m = -inf), sums of l and acc
    taken j = 0, 1, ... in turn, divided by max(l, 1e-30).

Inputs are made with numpy from a seed; the JAX Pallas kernel runs in
interpret mode. Tolerances: f32 rtol = atol = 1e-5 (the sums' order
differs); bf16 atol 2e-3 plus one bf16 step of the value (both sides round
an f32 result to bf16). The ``cuda``-marked test holds the kernel itself
against its plain version on the card, one launch a call and graph replays
bit for bit equal to the eager call.
"""
import inspect
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as tda

WARPS = 4             # warps of a kernel block
UNROLL = 4            # key rows a lane has in flight in one run
EPL = {torch.float32: 4, torch.bfloat16: 8}   # elements of a 16-byte load
H100_SMS = 132
NEG = -1e30
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def run_keys(hd: int, dtype) -> int:
    """Keys of one warp run: UNROLL loads of 32 / (hd / EPL) key rows."""
    return UNROLL * 32 // (hd // EPL[dtype])


def one_launch(q, k, v, lengths, launch, run):
    """csrc/decode_attention.cu in plain PyTorch. q [B, H, hd] and k / v
    [B, K, S, hd] hold the inputs' values as f32; returns [B, H, hd] f32,
    before the output is rounded to the input dtype."""
    B, H, hd = q.shape
    _, K, S, _ = k.shape
    G, scale = H // K, 1.0 / math.sqrt(hd)
    nsplit, chunk = launch.nsplit, launch.chunk
    out = torch.empty(B, H, hd)
    for b in range(B):
        n = int(lengths[b])
        for kh in range(K):
            qs = q[b, kh * G:(kh + 1) * G]                       # [G, hd]
            pm = torch.full((G, nsplit), -math.inf)
            pl = torch.zeros(G, nsplit)
            pa = torch.full((G, nsplit, hd), float("nan"))     # torch.empty
            for s in range(nsplit):
                lo, end = s * chunk, min(S, (s + 1) * chunk)
                hi = min(end, n) if n > 0 else end
                if hi <= lo:                  # past the length: no key read
                    continue
                wm, wl, wa = [], [], []
                for w in range(WARPS):
                    m = torch.full((G,), -math.inf)
                    l, acc = torch.zeros(G), torch.zeros(G, hd)
                    for c0 in range(lo + w * run, hi, WARPS * run):
                        pos = torch.arange(c0, min(c0 + run, hi))
                        if n > 0:
                            s_ = (qs @ k[b, kh, pos].T) * scale  # [G, run]
                        else:
                            s_ = torch.full((G, len(pos)), NEG)
                        m_new = torch.maximum(m, s_.amax(-1))
                        corr = torch.exp(m - m_new)
                        p = torch.exp(s_ - m_new[:, None])
                        l = l * corr + p.sum(-1)
                        acc = acc * corr[:, None] + p @ v[b, kh, pos]
                        m = m_new
                    wm.append(m), wl.append(l), wa.append(acc)
                wm, wl, wa = torch.stack(wm), torch.stack(wl), torch.stack(wa)
                mx = wm.amax(0)
                seen = wm != -math.inf
                c = torch.where(seen, torch.exp(wm - mx), 0.0)   # [W, G]
                pm[:, s] = mx
                pl[:, s] = (wl * c).sum(0)
                pa[:, s] = (torch.where(seen[..., None], wa, 0.0)
                            * c[..., None]).sum(0)
            # the last block's merge, in split order
            mx = pm.amax(1)                 # finite: split 0 read a key or V
            wgt = torch.where(pm == -math.inf, 0.0,
                              torch.exp(pm - mx[:, None]))
            lsum, a = torch.zeros(G), torch.zeros(G, hd)
            for j in range(nsplit):
                lsum = lsum + pl[:, j] * wgt[:, j]
                a = torch.where(wgt[:, j, None] != 0,
                                a + pa[:, j] * wgt[:, j, None], a)
            out[b, kh * G:(kh + 1) * G] = a / lsum.clamp_min(1e-30)[:, None]
    return out


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).bfloat16().float().numpy()


def _bf16_step(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (0 at 0)."""
    a = np.abs(x.astype(np.float32))
    e = np.floor(np.log2(np.maximum(a, 2.0**-126)))
    return np.where(a > 0, np.exp2(e - 7), 0.0)


def _case(seed, B, H, K, S, hd, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, hd), (B, K, S, hd), (B, K, S, hd)))
    if dtype == torch.bfloat16:
        q, k, v = _bf16(q), _bf16(k), _bf16(v)
    return q, k, v


def _jax(q, k, v, lengths, dtype):
    """The JAX kernel in interpret mode (imported here, so that the card's
    test below runs where JAX is not installed)."""
    import jax.numpy as jnp
    from repro.kernels import decode_attention as jda
    jt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    out = jda.flash_decode(*(jnp.asarray(x, jt) for x in (q, k, v)),
                           jnp.asarray(lengths))
    return np.asarray(out, np.float32)


def _hold(got, exp, dtype):
    if dtype == torch.float32:
        np.testing.assert_allclose(got, exp, **F32_TOL)
    else:
        lim = 2e-3 + _bf16_step(exp)
        assert np.all(np.abs(got - exp) <= lim), np.abs(got - exp).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_one_launch_matches_jax(hd, dtype):
    """Lengths 0, 1, 63, 65, a split boundary and S, with the splits the
    wrapper makes on a 16-SM card (three splits of 128 keys): the split
    walk, the warp merge and the last block's merge in split order equal
    the JAX kernel and the port's plain version; the empty slot is the mean
    of V over all S positions."""
    B, H, K, S = 6, 8, 2, 320
    launch = tda.decode_launch(B, H, K, S, hd, 16)
    assert (launch.nsplit, launch.chunk) == (3, 128)
    lengths = np.array([0, 1, 63, 65, launch.chunk, S], np.int32)
    q, k, v = _case(hd, B, H, K, S, hd, dtype)
    t = [torch.from_numpy(x) for x in (q, k, v, lengths)]
    got = one_launch(*t, launch, run_keys(hd, dtype))
    got = got.to(dtype).float().numpy()
    _hold(got, _jax(q, k, v, lengths, dtype), dtype)
    plain = tda.flash_decode_plain(*(x.to(dtype) for x in t[:3]), t[3])
    _hold(got, plain.float().numpy(), dtype)
    mean_v = np.repeat(v[0].mean(axis=1), H // K, axis=0)
    _hold(got[0], mean_v, dtype)
    assert np.isfinite(got).all()


def test_one_launch_two_row_groups_matches_jax():
    """G = 10 query rows per kv head: two row groups of a block's 8 rows,
    each with its own arrival counter, at the serving split (132 SMs)."""
    B, H, K, S, hd = 3, 20, 2, 384, 64
    launch = tda.decode_launch(B, H, K, S, hd, H100_SMS)
    assert launch.groups == 2 and launch.counters == B * K * 2
    lengths = np.array([383, 0, 129], np.int32)
    q, k, v = _case(7, B, H, K, S, hd, torch.float32)
    t = [torch.from_numpy(x) for x in (q, k, v, lengths)]
    got = one_launch(*t, launch, run_keys(hd, torch.float32)).numpy()
    _hold(got, _jax(q, k, v, lengths, torch.float32), torch.float32)


@pytest.mark.parametrize("B,H,K,S,hd,n_sm", [
    (8, 14, 2, 2048, 64, 132), (1, 14, 2, 2048, 64, 132),
    (6, 8, 2, 320, 64, 16), (3, 20, 2, 384, 64, 132),
    (1, 4, 4, 512, 128, 132), (2, 4, 2, 100, 32, 132),
    (1, 2, 1, 1, 16, 132), (1, 8, 1, 1 << 20, 128, 132),
    (64, 32, 8, 4096, 128, 132)])
def test_decode_launch(B, H, K, S, hd, n_sm):
    """Splits of whole 64-key runs that cover [0, S) once, no more than
    MAX_SPLITS, more than half of and at most the splits that put
    BLOCKS_PER_SM blocks on every SM, where the keys allow;
    counters and scratch sized for every (slot, kv head, row group) and
    (slot, query head, split); host ints only."""
    assert "lengths" not in inspect.signature(tda.decode_launch).parameters
    g = tda.decode_launch(B, H, K, S, hd, n_sm)
    groups = -(-(H // K) // tda.ROWS_PER_BLOCK)
    assert g.chunk % tda.MIN_SPLIT == 0
    assert (g.nsplit - 1) * g.chunk < S <= g.nsplit * g.chunk
    assert 1 <= g.nsplit <= tda.MAX_SPLITS
    covered = np.zeros(S, np.int64)
    for s in range(g.nsplit):
        covered[s * g.chunk:min(S, (s + 1) * g.chunk)] += 1
    assert (covered == 1).all()
    assert g.groups == groups
    assert g.blocks == g.nsplit * B * K * groups
    assert g.counters == B * K * groups
    assert (g.part_ml, g.part_acc) == (2 * B * H * g.nsplit,
                                       B * H * g.nsplit * hd)
    runs = -(-S // tda.MIN_SPLIT)
    pairs = B * K * groups
    want = min(runs, tda.MAX_SPLITS, -(-tda.BLOCKS_PER_SM * n_sm // pairs))
    assert want / 2 < g.nsplit <= want     # whole runs: at least half the aim
    if (B, H, K, S) == (8, 14, 2, 2048):   # the serving decode shape
        assert (g.nsplit, g.chunk, g.blocks) == (16, 128, 256)


def test_arrival_counters_are_made_once_and_kept():
    """The counters are zeroed once, reused by every call that fits, and
    grown, never freed, for one that does not (a captured graph keeps the
    address it was captured with)."""
    dev = torch.device("cpu")
    tda._COUNTERS.pop(dev, None)
    try:
        a = tda.arrival_counters(dev, 16)
        assert a.dtype == torch.int32 and not a.any() and a.numel() >= 16
        assert tda.arrival_counters(dev, a.numel()) is a
        b = tda.arrival_counters(dev, a.numel() + 1)
        assert b is not a and b.numel() > a.numel() and not b.any()
        assert tda._COUNTERS[dev] == [a, b]
    finally:
        tda._COUNTERS.pop(dev, None)


def test_sweep_cuts_match_the_kernel_source():
    """launch/kernel_sweep.py times the kernel with parts cut out by text
    edits of its source: each edit must find its line exactly once."""
    from repro_torch.kernels import _build
    from repro_torch.launch import kernel_sweep
    src = (_build.CSRC / "decode_attention.cu").read_text()
    for cut, edits in kernel_sweep.CUTS.items():
        for old, _ in edits:
            assert src.count(old) == 1, (cut, old)


@pytest.mark.cuda
def test_cuda_one_launch_per_call_and_graph_replays():
    """On the card, at the serving decode shape in bf16 and f32: one kernel
    launch a call, within 2e-3 (plus one bf16 step) of the plain version,
    the same bits on a second call, and two graph replays equal to the
    eager call bit for bit; the counters are back to 0 after each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_decode_split.py)")
    g = torch.Generator(device="cuda").manual_seed(0)
    B, H, K, S, hd = 8, 14, 2, 2048, 64
    lens = torch.tensor([0, 2048, 1, 63, 65, 128, 1000, 1601],
                        dtype=torch.int32, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(B, H, hd, generator=g, device="cuda").to(dtype)
        kc, vc = (torch.randn(B, K, S, hd, generator=g, device="cuda")
                  .to(dtype) for _ in range(2))
        n0 = tda.flash_decode.launches
        out = tda.flash_decode(q, kc, vc, lens)
        torch.cuda.synchronize()
        assert tda.flash_decode.launches == n0 + 1
        plain = tda.flash_decode_plain(q, kc, vc, lens).float()
        lim = 2e-3 + (2**-8 * plain.abs() if dtype == torch.bfloat16 else 0)
        assert bool(((out.float() - plain).abs() <= lim).all())
        assert torch.equal(tda.flash_decode(q, kc, vc, lens), out)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = tda.flash_decode(q, kc, vc, lens)
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(replayed, out)
        assert not tda._COUNTERS[q.device][-1].any()
