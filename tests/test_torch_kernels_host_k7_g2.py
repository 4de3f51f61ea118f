"""K7 on the kernels' host build against its plain twin: sum_rows at the other G2
shapes, and the G1 fill width.

Cases of tests/test_torch_kernels_host.py, spread over
tests/test_torch_kernels_host_k7_*.py by their time on the CPU (under
``--dist loadfile`` a file runs on one worker); the same names and
parameters.  The host build and the shared inputs come from
tests/torch_kernels_host_lib.py.
"""

import pytest

from torch_kernels_host_lib import (build_host_lib, check_sum_rows,
                                    check_sum_rows_width, k7_cases)
from torch_kernels_host_lib import kernel_path  # noqa: F401

ROWS, ROW_IDS = k7_cases("g2-1x1", "g2-1x1024")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_lib(tmp_path_factory)


@pytest.mark.parametrize("g2,rows,lanes", ROWS, ids=ROW_IDS)
def test_sum_rows_kernel_matches_plain(kernel_path, g2, rows, lanes):
    check_sum_rows(kernel_path, g2, rows, lanes)


@pytest.mark.parametrize("fill,g2", [(True, False)], ids=["fill-g1"])
def test_sum_rows_kernel_at_each_compiled_width(kernel_path, monkeypatch,
                                                g2, fill):
    check_sum_rows_width(monkeypatch, g2, fill)
