"""K7 on the kernels' host build against its plain twin: the G2 width, and G1
padding.

Cases of tests/test_torch_kernels_host.py, spread over
tests/test_torch_kernels_host_k7_*.py by their time on the CPU (under
``--dist loadfile`` a file runs on one worker); the same names and
parameters.  The host build and the shared inputs come from
tests/torch_kernels_host_lib.py.
"""

import pytest

from torch_kernels_host_lib import (build_host_lib, check_sum_rows_padding,
                                    check_sum_rows_width)
from torch_kernels_host_lib import kernel_path  # noqa: F401


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_lib(tmp_path_factory)


@pytest.mark.parametrize("fill,g2", [(False, True)], ids=["width-g2"])
def test_sum_rows_kernel_at_each_compiled_width(kernel_path, monkeypatch,
                                                g2, fill):
    check_sum_rows_width(monkeypatch, g2, fill)


@pytest.mark.parametrize("g2", [False], ids=["g1"])
def test_sum_rows_padding_costs_nothing_and_changes_nothing(kernel_path, g2):
    check_sum_rows_padding(g2)
