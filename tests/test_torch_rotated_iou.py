"""The rotated-IoU kernel's rejection test, on the CPU.

``csrc/rotated_iou.cu`` writes 0.0 for a pair it finds disjoint (bounding
circles, then separating axes, each with a margin) and clips only the
others.  ``ops/rotated_iou.py::disjoint_pairs`` mirrors that test in plain
PyTorch with the same margins; these tests hold every pair it rejects to a
plain IoU of exactly 0.0 under all three criteria, and check that no pair
with a degenerate box is rejected.  The kernel itself runs on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automatic_as_built_reconstruction_tpu.ops import (
    rotated_iou as jax_rotated_iou)
from automatic_as_built_reconstruction_tpu_torch.ops import rotated_iou
from chip_smoke import iou_cases, near_touching_cases


def _building(rng, R, K):
    """Building-scale boxes over 16 m, as served scans give NMS."""
    return np.concatenate([rng.uniform(0, 16, (R, K, 2)),
                           rng.uniform(0.05, 3.0, (R, K, 2)),
                           rng.uniform(-np.pi, np.pi, (R, K, 1))],
                          -1).astype(np.float32)


def _walls(rng, R, K, offset=0.0):
    """Thin walls (0.05-0.3 m x 1-6 m) at 0 and 90 degrees along the lines
    of a building's outline, with small jitter: their bounding circles
    overlap along a wall where the boxes do not."""
    b = np.zeros((R, K, 5))
    for r in range(R):
        for i in range(K):
            across = (rng.choice([0.0, 4.0, 8.0, 12.0, 16.0])
                      + rng.normal(0, 0.02))
            along = rng.uniform(0, 16)
            yaw = 0.0 if i % 2 else math.pi / 2
            x, y = (across, along) if yaw == 0.0 else (along, across)
            b[r, i] = [x + offset, y + offset, rng.uniform(0.05, 0.3),
                       rng.uniform(1, 6), yaw]
    return b.astype(np.float32)


def _nms_like(rng, R, K, offset=0.0):
    """Duplicates jittered around a few objects, as the top-scoring
    decoded anchors of a scan are."""
    objs = _building(rng, R, K // 10)
    b = np.repeat(objs, 10, 1) + rng.normal(0, 1, (R, K, 5)) * [
        0.1, 0.1, 0.05, 0.05, 0.1]
    b[..., 2:4] = np.abs(b[..., 2:4])
    b[..., :2] += offset
    return b.astype(np.float32)


def _sets():
    rng = np.random.default_rng(11)
    return {
        "building": (lambda: _building(rng, 2, 300)),
        "degenerate": (lambda: iou_cases(2, 300, seed=1)),
        "walls": (lambda: _walls(rng, 2, 300)),
        "walls 1e3 m out": (lambda: _walls(rng, 2, 300, offset=1e3)),
        "nms-like": (lambda: _nms_like(rng, 2, 300)),
        "nms-like 1e3 m out": (lambda: _nms_like(rng, 2, 300, offset=1e3)),
        "near-touching": (lambda: near_touching_cases(2, 400, seed=2)),
    }


@pytest.mark.parametrize("name", list(_sets()))
def test_rejected_pairs_have_zero_plain_iou(name):
    """Every pair the kernel would reject has plain IoU exactly 0.0 under
    criteria -1, 0 and 1, and intersection area exactly 0.0; the set
    exercises both stages and leaves pairs to clip."""
    b = torch.from_numpy(_sets()[name]())
    circles, axes = rotated_iou.reject_stages(b, b)
    rejected = rotated_iou.disjoint_pairs(b, b)
    assert torch.equal(rejected, circles | axes)
    assert int((axes & ~circles).sum()) > 0        # stage 2 does work
    assert 0 < int((~rejected).sum())              # pairs left to clip
    inter = rotated_iou.intersection_area_matrix_plain(b, b)
    assert bool((inter[rejected] == 0.0).all())
    for criterion in (-1, 0, 1):
        iou = rotated_iou.rotate_iou_matrix_plain(b, b, criterion)
        assert bool((iou[rejected] == 0.0).all()), criterion
    # the reverse roles (B clipped by A) too: the test is symmetric
    assert torch.equal(rejected, rotated_iou.disjoint_pairs(b, b)
                       .transpose(1, 2))


def test_rejected_pairs_are_zero_in_the_jax_package_too():
    rng = np.random.default_rng(12)
    a = np.concatenate([_walls(rng, 1, 200), _building(rng, 1, 200)], 1)
    q = np.concatenate([_nms_like(rng, 1, 200), _walls(rng, 1, 100)], 1)
    rejected = rotated_iou.disjoint_pairs(torch.from_numpy(a),
                                          torch.from_numpy(q))[0].numpy()
    assert rejected.mean() > 0.5
    for criterion in (-1, 0, 1):
        ref = np.asarray(jax_rotated_iou.rotate_iou_matrix(
            jnp.asarray(a[0]), jnp.asarray(q[0]), criterion=criterion))
        assert (ref[rejected] == 0.0).all()


def test_degenerate_boxes_are_never_rejected():
    """A box with a value not finite, w or l <= 0, a magnitude above 1e15,
    or too thin for its magnitude is never rejected, against any box; a
    zero-area B far away gives IoU 1.0 over area A (it keeps all of A),
    which a rejection would have turned into 0.0."""
    good = [[0.0, 0.0, 1.0, 2.0, 0.3], [50.0, -20.0, 0.5, 0.5, 1.0],
            [1e3, 1e3, 2.0, 4.0, -2.0]]
    bad = [[1e6, 1e6, 0.0, 0.0, 0.0],          # the pad box
           [40.0, 40.0, 0.0, 3.0, 0.0],        # zero width
           [40.0, 40.0, 3.0, 0.0, 0.0],        # zero length
           [40.0, 40.0, -1.0, 2.0, 0.0],       # negative width
           [40.0, 40.0, float("nan"), 1.0, 0.0],
           [float("inf"), 40.0, 1.0, 1.0, 0.0],
           [40.0, 40.0, 1.0, 1.0, float("nan")],
           [2e15, 0.0, 1.0, 1.0, 0.0],         # beyond 1e15
           [1e3, 0.0, 1e-3, 2.0, 0.0],         # 1 mm wide 1 km out
           [0.0, 0.0, 1e-5, 1.0, 0.7]]         # 1e-5 of its length
    b = torch.tensor([good + bad], dtype=torch.float32)
    rejected = rotated_iou.disjoint_pairs(b, b)[0]
    n = len(good)
    assert not bool(rejected[n:].any()) and not bool(rejected[:, n:].any())
    assert bool(rejected[:n, :n].fill_diagonal_(True).all())
    iou0 = rotated_iou.rotate_iou_matrix_plain(b, b, 0)[0]
    # 1.0 up to the shoelace's rounding on absolute coordinates
    assert float(iou0[0, n]) == pytest.approx(1.0, abs=1e-6)
    assert bool((iou0[:n, n] > 0.99).all())


def test_rejects_most_pairs_of_a_spread_out_set():
    rng = np.random.default_rng(13)
    b = np.concatenate([rng.uniform(0, 80, (2, 500, 2)),
                        rng.uniform(0.05, 3.0, (2, 500, 2)),
                        rng.uniform(-np.pi, np.pi, (2, 500, 1))], -1)
    rejected = rotated_iou.disjoint_pairs(*[torch.from_numpy(
        b.astype(np.float32))] * 2)
    assert float(rejected.float().mean()) > 0.9


def test_the_margin_is_where_the_kernel_puts_it():
    """Walls edge to edge at a gap of 1.01 times the summed margins are
    rejected, at 0.99 times not (``near_touching_cases``, kind 2): the
    mirror's margins are the ones the sets are built from."""
    K = 800
    b = near_touching_cases(1, K, seed=3)
    rejected = rotated_iou.disjoint_pairs(*[torch.from_numpy(b)] * 2)[0]
    i = np.arange(K // 2)
    # kind 2 near the origin (1e3 m out, these walls are too thin for
    # their magnitude: degenerate, never rejected)
    margin_pairs = i[(i % 4 == 2) & (i > 3) & (b[0, 2 * i, 0] < 100)]
    wider = margin_pairs[(margin_pairs // 4) % 2 == 1]
    narrower = margin_pairs[(margin_pairs // 4) % 2 == 0]
    got_w = rejected[2 * wider, 2 * wider + 1].float().mean()
    got_n = rejected[2 * narrower, 2 * narrower + 1].float().mean()
    assert float(got_w) >= 0.9 and float(got_n) <= 0.1, (got_w, got_n)


def test_ablation_variants_follow_the_kernel_source():
    """``rotated_iou_ablation.py`` derives its timing variants from
    ``csrc/rotated_iou.cu`` by text substitution: each must still apply
    exactly once, and change the source."""
    import rotated_iou_ablation

    sources = rotated_iou_ablation.variant_sources()
    shipped = rotated_iou_ablation.SOURCE.read_text()
    assert sources.pop("kernel") == shipped
    assert sources and all(src != shipped for src in sources.values())


# --------------------------------------------------------------------------
# the kernel's own device code, compiled for the host
# --------------------------------------------------------------------------

_HOST_SHIM = """
#include <cmath>
#include <cstdint>
#include <cstring>
#define __device__
#define __forceinline__ inline
using std::isfinite;
static inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
static inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
static inline int __popc(unsigned x) { return __builtin_popcount(x); }
"""

_HOST_ENTRIES = """
namespace {
struct Box {
  float cx[4], cy[4], c, s, r, tol;
};
Box prologue(const float* b) {  // as the kernel's per-box prologue
  Box o;
  o.c = cosf(b[4]);
  o.s = sinf(b[4]);
  box_corners(b[0], b[1], b[2], b[3], o.c, o.s, o.cx, o.cy);
  o.r = 0.5f * sqrtf(b[2] * b[2] + b[3] * b[3]);
  o.tol = reject_tol(b[0], b[1], b[2], b[3], b[4], o.r);
  return o;
}
}  // namespace

// clip_area of pair i, from corners [n, 8] (x0..x3, y0..y3) of A and B
extern "C" void host_clip(const float* ca, const float* cb, int n,
                          float* out) {
  float buf0[16], buf1[16];
  for (int i = 0; i < n; ++i)
    out[i] = clip_area(ca + 8 * i, ca + 8 * i + 4, cb + 8 * i,
                       cb + 8 * i + 4, buf0, buf1, 1);
}

// per pair of boxes [n, 5]: rejected (1) or not, and the clip area from
// the prologue's own corners
extern "C" void host_pairs(const float* a, const float* b, int n,
                           unsigned char* rejected, float* area) {
  float buf0[16], buf1[16];
  for (int i = 0; i < n; ++i) {
    const float* p = a + 5 * i;
    const float* q = b + 5 * i;
    const Box A = prologue(p), B = prologue(q);
    const float m = A.tol + B.tol;
    const float dx = q[0] - p[0], dy = q[1] - p[1];
    rejected[i] = circles_apart(dx, dy, A.r, B.r, m) ||
                  axes_apart(dx, dy, A.c, A.s, 0.5f * p[2], 0.5f * p[3], B.c,
                             B.s, 0.5f * q[2], 0.5f * q[3], m);
    area[i] = clip_area(A.cx, A.cy, B.cx, B.cy, buf0, buf1, 1);
  }
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """``csrc/rotated_iou.cu``'s ``__device__`` helpers (corners, margin,
    the two tests, the clip) built for the host with g++, no contraction
    of products and sums (as the kernel's -fmad=false), bound by ctypes."""
    import ctypes
    import shutil
    import subprocess

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    src = rotated_iou._build.CSRC_DIR.joinpath("rotated_iou.cu").read_text()
    helpers = src[src.index("namespace {"):src.index("__global__")]
    out = tmp_path_factory.mktemp("host_kernel")
    cpp = out / "rotated_iou_host.cpp"
    cpp.write_text(_HOST_SHIM + helpers + "}  // namespace\n" + _HOST_ENTRIES)
    lib = out / "librotated_iou_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off",
                    "-fno-fast-math", "-shared", "-fPIC", "-o", str(lib),
                    str(cpp)], check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    ptr = ctypes.c_void_p
    dll.host_clip.argtypes = [ptr, ptr, ctypes.c_int, ptr]
    dll.host_pairs.argtypes = [ptr, ptr, ctypes.c_int, ptr, ptr]
    return dll


def _pairs(dll, a, b):
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    rejected = np.zeros(len(a), np.uint8)
    area = np.zeros(len(a), np.float32)
    dll.host_pairs(a.ctypes.data, b.ctypes.data, len(a), rejected.ctypes.data,
                   area.ctypes.data)
    return rejected.astype(bool), area


@pytest.mark.parametrize("name", ["degenerate", "walls", "nms-like 1e3 m out",
                                  "near-touching"])
def test_kernel_clip_equals_the_plain_clip_bit_for_bit(host_kernel, name):
    """The kernel's ``clip_area``, fed the plain version's corners, gives
    its intersection areas bit for bit, on every pair (rejected or not)."""
    b = torch.from_numpy(_sets()[name]()[:1, :150])
    want = rotated_iou.intersection_area_matrix_plain(b, b)[0].numpy()
    xs, ys = rotated_iou._corners(b[0])                  # [4, K] each
    corners = torch.cat([xs, ys]).T.contiguous().numpy()    # [K, 8]
    K = corners.shape[0]
    ca = np.repeat(corners, K, 0)
    cb = np.tile(corners, (K, 1))
    got = np.zeros(K * K, np.float32)
    host_kernel.host_clip(ca.ctypes.data, cb.ctypes.data, K * K,
                          got.ctypes.data)
    np.testing.assert_array_equal(got.view(np.int32),
                                  want.reshape(-1).view(np.int32))


def test_kernel_rejection_holds_at_its_own_boundary(host_kernel):
    """Random pairs over five decades of size and six of distance from the
    origin, thin, axis-aligned and barely-thick-enough boxes among them:
    each B is moved toward its A along a random direction to the closest
    place where the kernel's test (its own code) still rejects it; the
    kernel's clip must give exactly 0.0 there and just beyond."""
    rng = np.random.default_rng(17)
    n = 20000
    scale = 10.0 ** rng.uniform(-2, 3, n)
    far = np.where(np.arange(n) % 3 == 0, 0.0, 10.0 ** rng.uniform(0, 6, n))
    a = np.stack([far * rng.uniform(-1, 1, n), far * rng.uniform(-1, 1, n),
                  scale * rng.uniform(0.02, 1, n),
                  scale * rng.uniform(0.02, 1, n),
                  rng.uniform(-np.pi, np.pi, n)], 1)
    s2 = scale * 10.0 ** rng.uniform(-1, 1, n)
    b = np.stack([np.zeros(n), np.zeros(n), s2 * rng.uniform(0.02, 1, n),
                  s2 * rng.uniform(0.02, 1, n),
                  rng.uniform(-np.pi, np.pi, n)], 1)
    aligned = np.arange(n) % 5 == 0
    a[aligned, 4] = b[aligned, 4] = np.where(np.arange(n)[aligned] % 2, 0.0,
                                              np.pi / 2)
    a[np.arange(n) % 7 == 0, 2] *= 0.01                        # thin
    just = np.arange(n) % 11 == 0     # just above the degenerate thinness
    mag = np.abs(a[:, 0]) + np.abs(a[:, 1]) + 0.5 * a[:, 3]
    a[just, 2] = mag[just] * rotated_iou.REJECT_TOL_REL * (
        1 + 0.05 * rng.random(just.sum()))
    phi = np.where(aligned, (np.arange(n) % 4) * np.pi / 2,
                   rng.uniform(-np.pi, np.pi, n))
    direction = np.stack([np.cos(phi), np.sin(phi)], 1)

    def placed(d):
        q = b.copy()
        q[:, :2] = a[:, :2] + d[:, None] * direction
        return q

    hi = 4 * (a[:, 2] + a[:, 3] + b[:, 2] + b[:, 3]) + 1
    far_ok, _ = _pairs(host_kernel, a, placed(hi))
    lo = np.zeros(n)
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        rej, _ = _pairs(host_kernel, a, placed(mid))
        hi, lo = np.where(rej, mid, hi), np.where(rej, lo, mid)
    tested = 0
    for step in (0.0, 1e-7, 1e-6):
        q = placed(hi * (1 + step))
        rej, area = _pairs(host_kernel, a, q)
        rej &= far_ok
        tested += int(rej.sum())
        assert (area[rej] == 0.0).all()
        _, back = _pairs(host_kernel, q, a)          # B clipped by A
        assert (back[rej] == 0.0).all()
    assert tested > 2 * n
