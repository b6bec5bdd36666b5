"""Kernels 4 and 5 (reduce_sum, inclusive_scan) on the CPU: the scan's
segment plan, its constants against the CUDA source, a plain-torch model
of the kernel's arithmetic, and the wrappers' CUDA branch.

The scan runs in one pass over segments (``reduce_scan.scan_plan``): each
block takes a segment by ticket, publishes its aggregate, and adds the
aggregates of the earlier segments in an order fixed by its index alone
(group totals of 32 segments, then the earlier aggregates of its own
group).  ``_model_scan`` repeats that arithmetic op for op in f32 and is
held to the same ``sum_limit`` as ``chip_smoke.py`` holds the kernel on
the card.  The kernels themselves run only on the card.
"""
import ast
import inspect
import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.kernels.reduce_scan import inclusive_scan_pallas
from repro_torch.kernels import reduce_scan as krs
from repro_torch.kernels import tuning

CSRC = pathlib.Path(krs.__file__).resolve().parent / "csrc"
CU = (CSRC / "reduce_scan.cu").read_text()
ELEM = (CSRC / "elem1d.cuh").read_text()
THREADS, WARPS, LANES = 256, 8, 32
U32, U16 = 2.0 ** -24, 2.0 ** -8
DTYPES = (torch.float32, torch.bfloat16)


def _items(dtype) -> int:
    return 16 // torch.empty((), dtype=dtype).element_size()


# ----------------------------------------------------------- segment plan

def _segment(plan, k, n):
    """[start, end) of segment k, as scan_kernel places it."""
    return k * plan.seg, min((k + 1) * plan.seg, n)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,block", [
    (1, 1024), (255, 1024), (1025, 1024), (5000, 1), (5000, 3000),
    (100003, 2048), (100003, 70000), (2 ** 20, 7168), (2 ** 20, 10 ** 6)])
def test_segments_cover_without_gap_or_overlap(n, block, dtype):
    item = torch.empty((), dtype=dtype).element_size()
    plan = krs.scan_plan(n, block, item)
    spans = [_segment(plan, k, n) for k in range(plan.n_segs)]
    assert spans[0][0] == 0 and spans[-1][1] == n
    for (_, hi), (lo, _) in zip(spans, spans[1:], strict=False):
        assert hi == lo
    assert all(lo < hi for lo, hi in spans)
    assert max(hi - lo for lo, hi in spans) <= krs.scan_seg_max(item)
    assert plan.n_segs == math.ceil(n / plan.seg)


@pytest.mark.parametrize("dtype", DTYPES)
def test_segment_is_the_block_capped_and_floored(dtype):
    item = torch.empty((), dtype=dtype).element_size()
    tile, cap = tuning.tile_elems(item), krs.scan_seg_max(item)
    assert cap == 8 * tile                   # 32 KiB of x
    least = krs.SCAN_SEG_MIN_TILES * tile
    assert least == 4 * tile and least < cap
    assert krs.scan_plan(10 ** 6, 5 * tile, item).seg == 5 * tile
    assert krs.scan_plan(10 ** 6, cap + 1, item).seg == cap
    assert krs.scan_plan(10 ** 6, 1, item).seg == least
    assert krs.scan_plan(10 ** 6, 3 * tile, item).seg == least
    assert krs.scan_plan(10 ** 6, 10 ** 7, item).seg == cap


@pytest.mark.parametrize("n,item,block,seg", [
    (2 ** 24, 4, 15360, 8192),     # the plan's block above the cap: split
    (2 ** 24, 2, 14336, 14336),    # fits in one segment
    (2 ** 26, 4, 63488, 8192),
    (2 ** 26, 2, 63488, 16384),
])
def test_main_path_plans_at_132_sms(n, item, block, seg):
    assert tuning.plan_1d(n, num_sms=132, bytes_per_elem=item).block == block
    plan = krs.scan_plan(n, block, item)
    assert plan.seg == seg
    # warp 0 reads at most a few group totals per lane at these sizes
    assert math.ceil(plan.n_groups / LANES) <= 8


def test_segment_boundaries_do_not_depend_on_ticket_order():
    n = 100003
    plan = krs.scan_plan(n, 2048, 4)
    order = np.random.default_rng(0).permutation(plan.n_segs)
    by_ticket = {int(k): _segment(plan, int(k), n) for k in order}
    assert by_ticket == {k: _segment(plan, k, n) for k in range(plan.n_segs)}


@pytest.mark.parametrize("n_segs", [1, 31, 32, 33, 64, 4097])
def test_group_membership_and_scratch_layout(n_segs):
    plan = krs.ScanPlan(seg=1024, n_segs=n_segs,
                        n_groups=math.ceil(n_segs / krs.SCAN_GROUP))
    groups = {}
    for k in range(n_segs):
        groups.setdefault(k // krs.SCAN_GROUP, []).append(k)
    assert sorted(groups) == list(range(plan.n_groups))
    for g, members in groups.items():
        assert members == list(range(g * 32, min(g * 32 + 32, n_segs)))
    # aggregates, group totals, then the ticket: one zeroed word each
    assert plan.scratch_words == n_segs + plan.n_groups + 1


def _constant(text: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", text)
    assert m, f"{name} not found"
    return int(m.group(1))


def test_plan_constants_match_the_cuda_source():
    threads = _constant(ELEM, "kThreads")
    assert threads == tuning.THREADS == THREADS
    assert "kItems = 16 / static_cast<int>(sizeof(T));" in ELEM
    assert re.search(r"kTileBytes = kThreads \* 16;", CU)
    assert _constant(CU, "kScanSegTiles") * threads * 16 == krs.SCAN_SEG_BYTES
    assert re.search(r"kStageTiles = kScanSegTiles \+ 1;", CU)
    assert _constant(CU, "kGroup") == krs.SCAN_GROUP
    # the ticket lies after the aggregates and the group totals
    assert "totals + (n_segs + kGroup - 1) / kGroup" in CU
    # entry points: (x, out, scratch, n, block or seg, dtype, stream)
    wrapper = inspect.getsource(krs._lib)
    assert "[vp, vp, vp, sz, sz, i, vp]" in wrapper
    for name in ("repro_reduce_sum", "repro_inclusive_scan"):
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', CU)
        assert m and len(m.group(1).split(",")) == 7


def test_kernels_use_tma_and_no_float_atomics():
    assert "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes" in CU
    assert "cp.async.bulk.global.shared::cta.bulk_group" in CU
    assert "ld.relaxed.gpu" in CU and "st.release.gpu" in CU
    assert "ld.global.nc" in ELEM or "__ldg" in ELEM
    assert not re.search(r"atomicAdd\((?!ticket|done)", CU)
    assert not re.search(r"\bred\.|atom\.add\.f", CU)
    for lib in ("cub/", "cub::", "thrust"):
        assert lib not in CU


# ------------------------------------------------- the kernel's arithmetic

def _hillis_steele(v):
    """warp_inclusive_scan over the last dim (32 lanes)."""
    for off in (1, 2, 4, 8, 16):
        v = torch.cat([v[..., :off], v[..., off:] + v[..., :-off]], dim=-1)
    return v


def _butterfly(v):
    """warp_sum over the last dim: every lane ends with these bits."""
    lane = torch.arange(LANES)
    for m in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ m]
    return v[..., 0]


def _seq_sum(v, dim):
    out = v.select(dim, 0).clone()
    for i in range(1, v.shape[dim]):
        out = out + v.select(dim, i)
    return out


def _model_scan(x: torch.Tensor, seg: int, offset: int = 0) -> torch.Tensor:
    """The scan kernel's arithmetic in f32, op for op, for a view whose
    first element lies ``offset`` elements past a 16-byte boundary."""
    n_items = _items(x.dtype)
    tile = THREADS * n_items
    xf = x.float()
    n = xf.numel()
    n_segs = math.ceil(n / seg)
    aggs, locals_ = [], []
    for k in range(n_segs):
        part = xf[k * seg:(k + 1) * seg]
        pad = (offset + k * seg) % n_items
        ntiles = math.ceil((pad + part.numel()) / tile)
        stage = torch.zeros(ntiles * tile)
        stage[pad:pad + part.numel()] = part
        v = stage.view(ntiles, WARPS, LANES, n_items)
        s = _hillis_steele(_seq_sum(v, 3))            # pass 1
        wt = s[..., LANES - 1]                        # warp totals
        t = torch.zeros(LANES)
        t[:ntiles] = _seq_sum(wt, 1)                  # tile totals
        incl = _hillis_steele(t)
        carry = torch.cat([torch.zeros(1), incl[:-1]])[:ntiles]
        aggs.append(incl[LANES - 1])
        wp = [torch.zeros(ntiles)]
        for w in range(1, WARPS):
            wp.append(wp[-1] + wt[:, w - 1])
        excl = torch.cat([torch.zeros(ntiles, WARPS, 1), s[..., :-1]], -1)
        run = (carry[:, None, None] + torch.stack(wp, 1)[:, :, None]) + excl
        runs = []
        for i in range(n_items):                      # pass 2
            run = run + v[..., i]
            runs.append(run)
        locals_.append(torch.stack(runs, -1).reshape(-1)[pad:pad + part.numel()])
    n_groups = math.ceil(n_segs / LANES)
    a = torch.zeros(n_groups * LANES)
    a[:n_segs] = torch.stack(aggs)
    totals = _butterfly(a.view(n_groups, LANES))
    out = []
    for k in range(n_segs):                           # look-back
        g, r = divmod(k, LANES)
        mine = a[g * LANES:(g + 1) * LANES].clone()
        mine[r:] = 0.0
        gs = torch.zeros(LANES)
        for h in range(g):
            gs[h % LANES] = gs[h % LANES] + totals[h]
        prefix = _butterfly(gs) + _butterfly(mine)
        out.append((prefix + locals_[k]).to(x.dtype))
    return torch.cat(out)


def _sum_limit(x, exact):
    """chip_smoke.sum_limit for a prefix sum, rounded once to x's type."""
    xd = x.double()
    n = xd.numel()
    m = torch.arange(1, n + 1, dtype=torch.float64)
    rms = float(xd.square().mean().sqrt())
    lim = 2 * U32 * exact.abs() + U32 * math.log2(max(n, 2)) * rms * m.sqrt()
    if x.dtype == torch.bfloat16:
        lim = lim + 2 * U16 * exact.abs()
    return lim


def _signed_ints(n, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(1, 9, n) * rng.choice([-1, 1], n)
                            ).float()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,seg,offset", [
    (1, 1024, 0), (1023, 1024, 0), (1025, 1024, 3), (5000, 2048, 1),
    (33 * 1024 + 7, 1024, 0),          # a group of 32 segments, and one more
    (70 * 1024, 1024, 5),              # three groups behind a misaligned head
    (20000, 8192, 2)])
def test_model_is_within_sum_limit_of_the_exact_sum(n, seg, offset, dtype):
    x = torch.from_numpy(np.random.default_rng(n + offset).standard_normal(
        n).astype(np.float32)).to(dtype)
    out = _model_scan(x, seg, offset)
    exact = torch.cumsum(x.double(), 0)
    lim = _sum_limit(x, exact)
    assert bool(((out.double() - exact).abs() <= lim).all())
    plain = krs.inclusive_scan_ref(x)
    assert bool(((out.double() - plain.double()).abs() <= 2 * lim).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,seg,offset", [
    (40 * 1024 + 3, 1024, 0), (40 * 1024 + 3, 1024, 6), (9000, 8192, 1)])
def test_model_is_exact_on_signed_integers(n, seg, offset, dtype):
    """Every partial sum of integers in ±[1, 8] is exact in f32 here, so
    the kernel's result is the exact prefix sum bit for bit."""
    x = _signed_ints(n, n).to(dtype)
    exact = torch.cumsum(x.double(), 0).to(dtype)
    assert torch.equal(_model_scan(x, seg, offset), exact)


def test_model_prefix_depends_on_the_segment_index_alone():
    """Two segmentations that share segment k's data and index, with the
    later segments' data changed, give segment k the same bits."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(40 * 1024).astype(np.float32))
    y = x.clone()
    y[35 * 1024:] = torch.from_numpy(
        rng.standard_normal(5 * 1024).astype(np.float32))
    a, b = _model_scan(x, 1024), _model_scan(y, 1024)
    assert torch.equal(a[:35 * 1024], b[:35 * 1024])


def test_model_matches_the_pallas_scan_in_f32():
    rng = np.random.default_rng(7)
    x = rng.standard_normal(8192).astype(np.float32)
    ref = inclusive_scan_pallas(jnp.asarray(x), block=1024, interpret=True)
    out = _model_scan(torch.from_numpy(x), 1024)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-4)


def test_bf16_scan_rounds_once():
    """The kernel rounds P + local once to bf16; the reference kernel
    rounds the in-block prefix to bf16 and then adds its offset, rounding
    twice.  Ours is the f32 result rounded once, and strays less from the
    exact prefix sum."""
    rng = np.random.default_rng(11)
    x32 = rng.standard_normal(8192).astype(np.float32)
    x = torch.from_numpy(x32).to(torch.bfloat16)
    ours = _model_scan(x, 1024)
    ours_f32 = _model_scan(x.float(), 1024)   # the same sums, not rounded
    assert torch.equal(ours, ours_f32.to(torch.bfloat16))
    ref = np.asarray(inclusive_scan_pallas(
        jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16), block=1024,
        interpret=True).astype(jnp.float32))
    exact = torch.cumsum(x.double(), 0).numpy()
    err_ours = np.abs(ours.double().numpy() - exact)
    err_ref = np.abs(ref.astype(np.float64) - exact)
    assert (ours.float().numpy() != ref).any()
    assert err_ours.max() <= err_ref.max()
    assert err_ours.mean() < err_ref.mean()


# -------------------------------------------------- the wrappers' CUDA branch

def _cuda_branch_calls(fn) -> set[str]:
    """Attribute names called in ``fn`` after its CPU early return."""
    tree = ast.parse(inspect.getsource(fn))
    body = tree.body[0].body
    assert isinstance(body[1], ast.If) and "cpu" in ast.unparse(body[1].test)
    names = set()
    for stmt in body[2:]:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call) and isinstance(node.func,
                                                         ast.Attribute):
                names.add(node.func.attr)
    return names


@pytest.mark.parametrize("fn", [krs.reduce_sum, krs.inclusive_scan])
def test_cuda_branch_calls_no_library_sum(fn):
    calls = _cuda_branch_calls(fn)
    assert not calls & {"cumsum", "sum", "cat", "to"}
    assert {"check", "add"} <= calls           # the launch is checked, counted


class _Record(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls.append(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


class _FakeLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["reduce_sum", "inclusive_scan"])
def test_one_call_launches_one_kernel_and_counts_one(name, dtype,
                                                     monkeypatch):
    """Driven on meta tensors (the CUDA branch, no card): one entry point
    called, one launch counted, one zeroed scratch of the plan's size, and
    no library sum, scan or concatenation on the way."""
    lib = _FakeLib()
    monkeypatch.setattr(krs, "_lib", lambda: lib)
    monkeypatch.setattr(tuning, "check_1d",
                        lambda kernel, x, block, dtypes: dtypes[x.dtype])

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    counter = krs.reduce_launches if name == "reduce_sum" else krs.scan_launches
    counter.reset()
    n, block = 100003, 2048
    x = torch.empty(n, dtype=dtype, device="meta")
    zeros = []
    real_zeros = torch.zeros

    def spy_zeros(*args, **kwargs):
        zeros.append(args[0])
        return real_zeros(*args, **kwargs)

    monkeypatch.setattr(torch, "zeros", spy_zeros)
    with _Record() as rec:
        out = getattr(krs, name)(x, block=block)
    assert counter.count == 1
    assert [c[0] for c in lib.calls] == [f"repro_{name}"]
    assert not {"cumsum", "sum", "cat"} & set(rec.calls)
    item = x.element_size()
    if name == "reduce_sum":
        assert out.shape == () and out.dtype == dtype
        assert zeros == [math.ceil(n / block) + 1]
        assert lib.calls[0][1][4] == block
    else:
        plan = krs.scan_plan(n, block, item)
        assert out.shape == (n,) and out.dtype == dtype
        assert zeros == [plan.scratch_words]
        assert lib.calls[0][1][4] == plan.seg
    counter.reset()
