"""K7 on the kernels' host build against its plain twin: sum_rows at the G1 shapes up to
1,024 lanes and at G2 2 x 257.

Cases of tests/test_torch_kernels_host.py, spread over
tests/test_torch_kernels_host_k7_*.py by their time on the CPU (under
``--dist loadfile`` a file runs on one worker); the same names and
parameters.  The host build and the shared inputs come from
tests/torch_kernels_host_lib.py.
"""

import pytest

from torch_kernels_host_lib import build_host_lib, check_sum_rows, k7_cases
from torch_kernels_host_lib import kernel_path  # noqa: F401

ROWS, ROW_IDS = k7_cases("g1-1x1", "g1-2x255", "g1-8x256", "g1-2x257",
                         "g1-1x1024", "g2-2x257")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_lib(tmp_path_factory)


@pytest.mark.parametrize("g2,rows,lanes", ROWS, ids=ROW_IDS)
def test_sum_rows_kernel_matches_plain(kernel_path, g2, rows, lanes):
    check_sum_rows(kernel_path, g2, rows, lanes)
