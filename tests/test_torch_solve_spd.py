"""``ops/linalg.solve_spd`` on the CPU: CPU tensors take the plain version
(``solve_spd_plain``, held to the JAX package in tests/test_torch_fit.py)
and count no kernel launch; the wrapper refuses what the CUDA solve
(``csrc/linalg.cu``) does not take before anything launches.  The kernel
itself is held to the plain version bit for bit on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import re

import pytest
import torch

from _torch_spd import KINDS, bits, spd_systems
from cylinder_pose_estimation_tpu_torch.ops import kernels, linalg

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)

LEADS = ((0,), (2,), (16,), (26,), (32, 48))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", [3, 5, 6])
def test_cpu_tensors_take_the_plain_solve(p, dtype, kind):
    kernels.reset_launch_counts()
    for i, lead in enumerate(LEADS):
        a, b = spd_systems(p, lead, dtype, kind, seed=i)
        got = linalg.solve_spd(a, b)
        want = linalg.solve_spd_plain(a, b)
        assert got.shape == want.shape == b.shape and got.dtype == dtype
        assert torch.equal(bits(got), bits(want)), lead
    assert kernels.launch_counts()["solve_spd"] == 0


def test_cpu_solve_reads_a_strided_rhs():
    a, b = spd_systems(6, (16,), torch.float32, "damped")
    bt = b.t().contiguous().t()
    assert not bt.is_contiguous()
    assert torch.equal(linalg.solve_spd(a, bt), linalg.solve_spd_plain(a, b))


@pytest.mark.parametrize("shape_a, shape_b", [((6, 6), (6,)), ((0, 6, 6), (0, 6)), ((32, 48, 3, 3), (32, 48, 3)),
                                              ((4, 1, 1), (4, 1)), ((2, 8, 8), (2, 8))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spd_check_accepts_what_the_kernel_takes(shape_a, shape_b, dtype):
    a, b = torch.zeros(shape_a, dtype=dtype), torch.zeros(shape_b, dtype=dtype)
    assert linalg._check_spd(a, b) == shape_a[-1]


REFUSED = {
    "float16": (torch.zeros(2, 6, 6, dtype=torch.float16), torch.zeros(2, 6, dtype=torch.float16)),
    "int": (torch.zeros(2, 6, 6, dtype=torch.int32), torch.zeros(2, 6, dtype=torch.int32)),
    "mixed_dtypes": (torch.zeros(2, 6, 6), torch.zeros(2, 6, dtype=torch.float64)),
    "vector": (torch.zeros(6), torch.zeros(6)),
    "not_square": (torch.zeros(2, 6, 5), torch.zeros(2, 6)),
    "order_9": (torch.zeros(2, 9, 9), torch.zeros(2, 9)),
    "order_0": (torch.zeros(2, 0, 0), torch.zeros(2, 0)),
    "lead_shapes_differ": (torch.zeros(2, 6, 6), torch.zeros(3, 6)),
    "broadcast_rhs": (torch.zeros(2, 6, 6), torch.zeros(6)),
    "rhs_order": (torch.zeros(2, 6, 6), torch.zeros(2, 5)),
    "devices_differ": (torch.zeros(2, 6, 6), torch.zeros(2, 6, device="meta")),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_spd_check_refuses(case):
    a, b = REFUSED[case]
    with pytest.raises(ValueError, match="solve_spd"):
        linalg._check_spd(a, b)


def test_solve_spd_refuses_other_devices():
    a, b = torch.zeros(2, 6, 6, device="meta"), torch.zeros(2, 6, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        linalg.solve_spd(a, b)


def test_solve_spd_entry_points_match_their_signatures():
    """Each C entry of csrc/linalg.cu takes the pointers and ints
    ``kernels.ENTRIES`` declares, then the stream."""
    src = (kernels.CSRC / "linalg.cu").read_text()
    for name in ("cpe_solve_spd_factor", "cpe_solve_spd_refine"):
        params = re.search(rf"CPE_API int {name}\(([^)]*)\)", src).group(1).split(",")
        kinds = [("ptr" if "*" in q else "int" if q.split()[0] == "int" else q.split()[0]) for q in params]
        n_ptr, n_int, n_float = kernels.ENTRIES[name]
        assert kinds == ["ptr"] * n_ptr + ["int"] * n_int + ["float"] * n_float + ["cudaStream_t"], kinds
    assert linalg.SPD_MAX_ORDER == int(re.search(r"kSpdMaxOrder = (\d+);", src).group(1))
