"""The arithmetic and host logic of the port's paged attention kernels on
the H100, held against the JAX reference kernels on the CPU.

The CUDA kernels cannot run here, so their arithmetic is written out below
in plain PyTorch, step for step as csrc/paged_decode_attention.cu and
csrc/paged_prefill_attention.cu do it:

  * decode: the page walk cut into splits of whole pages, warps that each
    keep an online softmax over every fourth run of keys, one merge of the
    warps per block, then the merge of the splits (exp(m_j - max m), splits
    past a slot's length carrying m = -inf and l = 0);
  * prefill: 64-key tiles on tensor cores with bf16 operands, f32 q and f32
    probabilities fed as hi + lo pairs of bf16 values, the key axis split as
    the wrapper splits it, and the same merge.

Inputs are made with numpy from a seed; the JAX Pallas kernels run in
interpret mode. Tolerance rtol = atol = 2e-3, as in the JAX kernel tests.
The split-count and scratch-shape functions the wrappers launch with are
tested here too: they take host ints only, never ``lengths``.
"""
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import paged_decode_attention as jpda
from repro.kernels import paged_prefill_attention as jppa
from repro.serve import kvquant
from repro_torch.kernels import paged_decode_attention as tpda
from repro_torch.kernels import paged_prefill_attention as tppa

TOL = dict(rtol=2e-3, atol=2e-3)
NEG = -1e30
WARPS = 4            # warps of a decode block
KEY_TILE = 64        # keys of a prefill tile
H100_SMS = 132


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 values, kept as f32 (what bf16 pages hold)."""
    return torch.from_numpy(x).bfloat16().float().numpy()


def _hi_lo(x: torch.Tensor):
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def merge_splits(m, l, acc):
    """The merge kernel: m, l [..., nsplit], acc [..., nsplit, hd]. Splits
    with m = -inf weigh 0 (and their acc is not read); a row whose splits
    all saw no key is 0."""
    mx = m.amax(dim=-1, keepdim=True)
    seen = m != -math.inf
    w = torch.where(seen, torch.exp(m - torch.where(seen, mx, 0.0)), 0.0)
    num = (torch.where(seen[..., None], acc, 0.0) * w[..., None]).sum(-2)
    return num / (l * w).sum(-1, keepdim=True).clamp_min(1e-30)


# ---------------------------------------------------------------------------
# decode: the split page walk
# ---------------------------------------------------------------------------
def decode_split_walk(q, kp, vp, table, lengths, pages_per_split,
                      keys_per_warp, k_scale=None, v_scale=None):
    """csrc/paged_decode_attention.cu in plain PyTorch: q [B, H, hd] f32,
    pages [P, K, pt, hd], table [B, max_pages], lengths [B]."""
    B, H, hd = q.shape
    _, K, pt, _ = kp.shape
    G, max_pages = H // K, table.shape[1]
    nsplit = -(-max_pages // pages_per_split)
    kw = keys_per_warp
    out = torch.zeros(B, H, hd)
    for b in range(B):
        n = min(int(lengths[b]), max_pages * pt)
        for kh in range(K):
            qs = q[b, kh * G:(kh + 1) * G].float() / math.sqrt(hd)  # [G, hd]
            pm = torch.full((G, nsplit), -math.inf)
            pl = torch.zeros(G, nsplit)
            pa = torch.full((G, nsplit, hd), float("nan"))  # torch.empty
            for s in range(nsplit):
                lo = s * pages_per_split * pt
                hi = min(n, lo + pages_per_split * pt)
                if hi <= lo:                  # past the length: no key read
                    continue
                wm, wl, wa = [], [], []
                for w in range(WARPS):
                    m = torch.full((G,), -math.inf)
                    l, acc = torch.zeros(G), torch.zeros(G, hd)
                    for c0 in range(lo + w * kw, hi, WARPS * kw):
                        pos = torch.arange(c0, min(c0 + kw, hi))
                        pid = table[b, pos // pt].clamp_min(0).long()
                        k = kp[pid, kh, pos % pt].float()      # [n, hd]
                        v = vp[pid, kh, pos % pt].float()
                        s_ = qs @ k.T                          # [G, n]
                        if k_scale is not None:
                            s_ = s_ * k_scale[pid, kh]
                        m_new = torch.maximum(m, s_.amax(-1))
                        corr = torch.exp(m - m_new)
                        p = torch.exp(s_ - m_new[:, None])
                        pv = p * v_scale[pid, kh] if v_scale is not None \
                            else p
                        l = l * corr + p.sum(-1)
                        acc = acc * corr[:, None] + pv @ v
                        m = m_new
                    wm.append(m), wl.append(l), wa.append(acc)
                wm, wl, wa = torch.stack(wm), torch.stack(wl), torch.stack(wa)
                mx = wm.amax(0)
                seen = wm != -math.inf
                c = torch.where(seen, torch.exp(wm - mx), 0.0)  # [W, G]
                pm[:, s] = mx
                pl[:, s] = (wl * c).sum(0)
                pa[:, s] = (torch.where(seen[..., None], wa, 0.0)
                            * c[..., None]).sum(0)
            out[b, kh * G:(kh + 1) * G] = merge_splits(pm, pl, pa)
    return out


def _decode_setup(rng, B, K, hd, pt, lengths, max_pages, n_pages=None):
    n_pages = n_pages or sum(-(-int(n) // pt) for n in lengths) + 3
    kp = rng.standard_normal((n_pages, K, pt, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, K, pt, hd)).astype(np.float32)
    table = np.full((B, max_pages), -1, np.int32)
    perm = rng.permutation(n_pages)
    i = 0
    for b, n in enumerate(lengths):
        need = -(-int(n) // pt)
        table[b, :need] = perm[i:i + need]
        i += need
    return kp, vp, table


def _jax_decode(q, kp, vp, table, lengths, **scales):
    return np.asarray(jpda.paged_flash_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths), **{k: jnp.asarray(v) for k, v in
                                 scales.items()}))


@settings(max_examples=12, deadline=None)
@given(pages_per_split=st.integers(1, 6),
       keys_per_warp=st.sampled_from([1, 2, 4, 8, 16, 32]),
       lengths=st.lists(st.integers(0, 48), min_size=3, max_size=3),
       seed=st.integers(0, 2**16))
def test_split_walk_matches_jax(pages_per_split, keys_per_warp, lengths,
                                seed):
    """Split sizes from one page to the whole table, splits past a slot's
    length, and a length-0 slot (always present): the split walk with the
    merge equals the JAX kernel, and the empty slot is exactly 0."""
    rng = np.random.default_rng(seed)
    B, H, K, hd, pt, max_pages = 4, 6, 2, 32, 8, 6
    lens = np.array(lengths + [0], np.int32)
    kp, vp, table = _decode_setup(rng, B, K, hd, pt, lens, max_pages)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    got = decode_split_walk(*map(torch.from_numpy, (q, kp, vp, table, lens)),
                            pages_per_split, keys_per_warp).numpy()
    np.testing.assert_allclose(got, _jax_decode(q, kp, vp, table, lens),
                               **TOL)
    np.testing.assert_array_equal(got[3], np.zeros((H, hd), np.float32))
    assert np.isfinite(got).all()


def test_split_walk_at_the_wrapper_split_matches_jax():
    """The split the wrapper launches with at a serving-like shape (B 4,
    G 7, hd 64, pt 16, 24 pages of table on 132 SMs), bf16 pages: equal to
    the JAX kernel and to the port's plain version."""
    rng = np.random.default_rng(3)
    B, H, K, hd, pt, max_pages = 4, 14, 2, 64, 16, 24
    lens = np.array([0, 1, 200, 384], np.int32)
    kp, vp, table = _decode_setup(rng, B, K, hd, pt, lens, max_pages)
    kp, vp = _bf16(kp), _bf16(vp)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    grid = tpda.decode_grid(B, H, K, hd, max_pages, H100_SMS)
    assert grid.nsplit > 1
    args = list(map(torch.from_numpy, (q, kp, vp, table, lens)))
    got = decode_split_walk(*args, grid.pages_per_split, 8).numpy()
    np.testing.assert_allclose(got, _jax_decode(q, kp, vp, table, lens),
                               **TOL)
    np.testing.assert_allclose(got, tpda.paged_flash_decode_plain(
        *args).numpy(), **TOL)


def test_split_walk_int8_pages_match_jax():
    """int8 pages: K's scale on the logit, V's on the probability."""
    rng = np.random.default_rng(21)
    B, H, K, hd, pt, max_pages = 3, 6, 3, 64, 8, 12
    lens = np.array([90, 0, 33], np.int32)
    kp, vp, table = _decode_setup(rng, B, K, hd, pt, lens, max_pages)
    kq, ks = (np.asarray(a) for a in kvquant.quantize_pages(jnp.asarray(kp)))
    vq, vs = (np.asarray(a) for a in kvquant.quantize_pages(jnp.asarray(vp)))
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    t = [torch.from_numpy(np.array(a))
         for a in (q, kq, vq, table, lens, ks, vs)]
    got = decode_split_walk(*t[:5], 2, 4, k_scale=t[5], v_scale=t[6])
    exp = _jax_decode(q, kq, vq, table, lens, k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(got.numpy(), exp, **TOL)


# ---------------------------------------------------------------------------
# the wrappers' launch shapes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,H,K,hd,max_pages,n_sm", [
    (8, 14, 2, 64, 128, 132), (1, 14, 2, 64, 128, 132),
    (3, 6, 3, 32, 8, 132), (8, 14, 2, 64, 1, 132), (64, 32, 8, 128, 64, 132),
    (2, 24, 1, 128, 40, 16)])
def test_decode_grid(B, H, K, hd, max_pages, n_sm):
    """Splits of whole pages that cover the table, no more splits than
    pages, about 4 blocks per SM where the pages allow, scratch sized for
    every (slot, query head, split); host ints only."""
    assert "lengths" not in inspect.signature(tpda.decode_grid).parameters
    g = tpda.decode_grid(B, H, K, hd, max_pages, n_sm)
    groups = -(-(H // K) // tpda.ROWS_PER_BLOCK)
    assert g.nsplit * g.pages_per_split >= max_pages
    assert (g.nsplit - 1) * g.pages_per_split < max_pages
    assert 1 <= g.nsplit <= max_pages
    assert g.blocks == g.nsplit * B * K * groups
    assert g.blocks >= min(n_sm, B * K * groups * max_pages)
    assert (g.part_ml, g.part_acc) == (2 * B * H * g.nsplit,
                                       B * H * g.nsplit * hd)
    if (B, H, K, max_pages) == (8, 14, 2, 128):   # the serving decode shape
        assert (g.nsplit, g.pages_per_split, g.blocks) == (32, 4, 512)


@pytest.mark.parametrize("C,start,dtype,blocks", [
    (256, 1500, torch.bfloat16, 280), (37, 100, torch.bfloat16, 30),
    (256, 0, torch.float16, 224), (1, 2047, torch.bfloat16, 64),
    (256, 1500, torch.int8, 56), (37, 100, torch.float32, 10)])
def test_prefill_grid(C, start, dtype, blocks):
    """At the serving shape (H 14, K 2, hd 64, pt 16, 128 pages): the
    tensor-core kernel's key split puts two blocks on every SM at C 256; the
    split covers the keys in whole 64-key tiles, and f32 / int8 pages keep
    the CUDA-core grid without a split or scratch."""
    H, K, hd, pt, max_pages = 14, 2, 64, 16, 128
    g = tppa.prefill_grid(C, H, K, hd, pt, max_pages, start, H100_SMS, dtype)
    keys = min(start + C, max_pages * pt)
    assert g.blocks == blocks
    assert g.nsplit * g.tiles_per_split * KEY_TILE >= keys
    if dtype in tppa.TENSOR_CORE_DTYPES:
        assert (g.nsplit - 1) * g.tiles_per_split * KEY_TILE < keys
        assert g.blocks >= H100_SMS or g.nsplit == -(-keys // KEY_TILE)
        assert g.blocks >= min(H100_SMS, blocks)
        n = C * H * g.nsplit if g.nsplit > 1 else 0
        assert (g.part_ml, g.part_acc) == (2 * n, n * hd)
    else:
        assert (g.nsplit, g.part_ml, g.part_acc) == (1, 0, 0)


# ---------------------------------------------------------------------------
# prefill: tensor-core products with hi + lo operands
# ---------------------------------------------------------------------------
def prefill_mma(q, kd, vd, start, tiles_per_split, split_p=True):
    """csrc/paged_prefill_attention.cu's tensor-core kernel in plain
    PyTorch: q [C, H, hd] f32, kd / vd [K, S, hd] (bf16 values, gathered
    from the pages). Q (scaled) is fed as bf16 hi + lo; P too, or, with
    ``split_p=False``, as one bf16 value. Products of bf16 values are exact
    in f32, and sums are f32, as in the tensor cores."""
    C, H, hd = q.shape
    K, S, _ = kd.shape
    G = H // K
    keys = min(start + C, S)
    nsplit = -(-keys // (tiles_per_split * KEY_TILE))
    rows = torch.arange(C * G)
    lim = torch.clamp(start + rows // G + 1, max=S)                # [R]
    out = torch.zeros(C, H, hd)
    for kh in range(K):
        qr = q[:, kh * G:(kh + 1) * G].reshape(C * G, hd).float()
        qh, ql = _hi_lo(qr / math.sqrt(hd))
        pm = torch.full((C * G, nsplit), -math.inf)
        pl = torch.zeros(C * G, nsplit)
        pa = torch.zeros(C * G, nsplit, hd)
        for s in range(nsplit):
            klo = s * tiles_per_split * KEY_TILE
            khi = min(keys, klo + tiles_per_split * KEY_TILE)
            m = torch.full((C * G,), -math.inf)
            l, acc = torch.zeros(C * G), torch.zeros(C * G, hd)
            for kb in range(klo, khi, KEY_TILE):
                kt = kd[kh, kb:kb + KEY_TILE].float()
                vt = vd[kh, kb:kb + KEY_TILE].float()
                sc = qh @ kt.T + ql @ kt.T                          # [R, n]
                pos = kb + torch.arange(kt.shape[0])
                vis = pos[None, :] < lim[:, None]
                sc = torch.where(vis, sc, NEG)
                m_new = torch.maximum(m, sc.amax(-1))
                corr = torch.exp(m - m_new)
                p = torch.where(vis, torch.exp(sc - m_new[:, None]), 0.0)
                l = l * corr + p.sum(-1)
                ph, plo = _hi_lo(p) if split_p else (p.bfloat16().float(),
                                                     torch.zeros_like(p))
                acc = acc * corr[:, None] + ph @ vt + plo @ vt
                m = m_new
            pm[:, s] = torch.where(l > 0, m, -math.inf)
            pl[:, s], pa[:, s] = l, acc
        o = merge_splits(pm, pl, pa)                                # [R, hd]
        out[:, kh * G:(kh + 1) * G] = o.reshape(C, G, hd)
    return out


def _prefill_pool(rng, K, hd, pt, S, max_pages):
    n_pages = max_pages + 2
    kp = _bf16(rng.standard_normal((n_pages, K, pt, hd)).astype(np.float32))
    vp = _bf16(rng.standard_normal((n_pages, K, pt, hd)).astype(np.float32))
    table = np.full((max_pages,), -1, np.int32)
    need = -(-S // pt)
    table[:need] = rng.permutation(n_pages)[:need]
    return kp, vp, table


def _dense(pages, table):
    return tpda.gather_pages(torch.from_numpy(pages),
                             torch.from_numpy(table)[None])[0]


def _jax_prefill(q, kp, vp, table, start):
    return np.asarray(jppa.paged_flash_prefill(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(start, jnp.int32)))


def test_hi_lo_products_hold_short_and_long_rows():
    """The main head shape (H 14, K 2, hd 64, pt 16), bf16 pages, f32 q:
    rows that see 1, 2 and 1756 keys. Row (c 1, head 0) sees two keys with
    probabilities 1 : 0.998 and values 0 and 4, the short-row case: one
    bf16 step of p moves its output by ~4e-3. With P as one bf16 value the
    emulation misses the JAX kernel by more than 2e-3 there; with hi + lo
    it holds 2e-3 on every row."""
    rng = np.random.default_rng(14)
    H, K, hd, pt, G = 14, 2, 64, 16, 7
    max_pages = 110                                  # 1760 keys
    kp, vp, table = _prefill_pool(rng, K, hd, pt, 1756, max_pages)
    # keys 0 and 1 of kv head 0: k0 = 0, k1 = e_0; v0 = 0, v1 = 4
    p0 = table[0]
    kp[p0, 0, :2] = 0.0
    kp[p0, 0, 1, 0] = 1.0
    vp[p0, 0, 0] = 0.0
    vp[p0, 0, 1] = 4.0
    kd, vd = _dense(kp, table), _dense(vp, table)
    for C, start in [(2, 0), (1, 1755)]:             # 1 and 2 keys; 1756
        q = rng.standard_normal((C, H, hd)).astype(np.float32)
        if start == 0:       # logit of key 1 over key 0: log(0.998)
            q[1, 0] = 0.0
            q[1, 0, 0] = math.log(0.998) * math.sqrt(hd)
        exp = _jax_prefill(q, kp, vp, table, start)
        tq = torch.from_numpy(q)
        tps = tppa.prefill_grid(C, H, K, hd, pt, max_pages, start, H100_SMS,
                                torch.bfloat16).tiles_per_split
        got = prefill_mma(tq, kd, vd, start, tps).numpy()
        np.testing.assert_allclose(got, exp, **TOL)
        if start == 0:
            one = prefill_mma(tq, kd, vd, start, tps, split_p=False).numpy()
            assert abs(one[1, 0, 0] - exp[1, 0, 0]) > 2e-3
            assert abs(got[1, 0, 0] - exp[1, 0, 0]) < 1e-4
            # one visible key: p = 1 exactly, the output is that key's V
            for kh in range(K):
                np.testing.assert_array_equal(
                    got[0, kh * G:(kh + 1) * G],
                    np.broadcast_to(vd[kh, 0].numpy(), (G, hd)))


@pytest.mark.parametrize("C,start,pt,hd", [(37, 100, 16, 64), (8, 56, 8, 128),
                                           (64, 3, 8, 128), (5, 11, 4, 32)])
def test_prefill_mma_split_matches_jax(C, start, pt, hd):
    """The tensor-core arithmetic at the split the wrapper launches with
    (several splits at these shapes), pt 4 / 8 / 16 and hd 32 / 64 / 128:
    equal to the JAX kernel and the port's plain version."""
    rng = np.random.default_rng(C * 7 + start)
    H, K = 14, 2
    max_pages = -(-(start + C) // pt) + 1
    kp, vp, table = _prefill_pool(rng, K, hd, pt, start + C, max_pages)
    q = rng.standard_normal((C, H, hd)).astype(np.float32)
    g = tppa.prefill_grid(C, H, K, hd, pt, max_pages, start, H100_SMS,
                          torch.bfloat16)
    got = prefill_mma(torch.from_numpy(q), _dense(kp, table),
                      _dense(vp, table), start, g.tiles_per_split).numpy()
    np.testing.assert_allclose(got, _jax_prefill(q, kp, vp, table, start),
                               **TOL)
    plain = tppa.paged_flash_prefill_plain(
        *map(torch.from_numpy, (q, kp, vp, table)), start)
    np.testing.assert_allclose(got, plain.numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32", "int8"])
def test_cuda_paged_kernels_every_page_dtype(dtype):
    """On the card: decode (every page dtype takes the split kernel) and
    prefill (bf16 / f16 on tensor cores, f32 / int8 on CUDA cores) at
    pt 8 / hd 128 against their plain versions within 2e-3, a length-0
    slot exactly 0, and both wrappers captured in a CUDA graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_paged_split.py)")
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(1)
    B, H, K, hd, pt, P, max_pages = 4, 14, 2, 128, 8, 80, 40
    kp, vp = (torch.randn(P, K, pt, hd, generator=g, device="cuda")
              for _ in range(2))
    scales = {}
    if dt == torch.int8:
        for name, x in (("k", kp), ("v", vp)):
            s = x.abs().amax(dim=(-1, -2)) / 127.0
            scales[name + "_scale"] = s.contiguous()
            x.copy_(torch.round(x / s[..., None, None]))
    kp, vp = kp.to(dt).contiguous(), vp.to(dt).contiguous()
    table = (torch.randperm(P, generator=torch.Generator().manual_seed(2))
             [:B * max_pages // 2].reshape(B, -1).int().cuda())
    table = torch.cat([table, torch.full_like(table, -1)], dim=1)
    lengths = torch.tensor([0, 1, 77, 160], dtype=torch.int32, device="cuda")
    q = torch.randn(B, H, hd, generator=g, device="cuda")
    out = tpda.paged_flash_decode(q, kp, vp, table, lengths, **scales)
    ref = tpda.paged_flash_decode_plain(q, kp, vp, table, lengths, **scales)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 2e-3
    assert out[0].abs().max().item() == 0.0
    q2 = torch.randn(37, H, hd, generator=g, device="cuda")
    pre = (lambda: tppa.paged_flash_prefill(q2, kp, vp, table[3], 123,
                                            **scales))
    ref2 = tppa.paged_flash_prefill_plain(q2, kp, vp, table[3], 123,
                                          **scales)
    assert (pre() - ref2).abs().max().item() <= 2e-3
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_dec = tpda.paged_flash_decode(q, kp, vp, table, lengths, **scales)
        g_pre = pre()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(g_dec, out)
    assert (g_pre - ref2).abs().max().item() <= 2e-3
