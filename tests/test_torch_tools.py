"""Host-side helpers of ``tools/kernel_turns.py`` (no GPU needed).

``kernel_key`` names a kernel of a disassembly so that the float32
instantiation of a kernel templated on its element type meets the float32
kernel of an earlier source of the same name, and a float64 instantiation
(or the float64 path kernel, which has no type argument) meets nothing of
float32. ``--f64`` builds the parent's float64 K1 and K2 from whichever
sources hold them and K3's from ``path_sim.cu`` (``f64_sources``), and reads
the parent's float64 paths against the current ones in ulp (``ulps_apart``).
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from kernel_turns import f64_sources, kernel_key, ulps_apart  # noqa: E402

K1_ARGS = "(storage_kernels::Operands<float>, storage_kernels::BasisDesc)"


@pytest.mark.parametrize("demangled,key", [
    ("storage_kernels::backward_update_kernel<float, 3>" + K1_ARGS,
     ("storage_kernels::backward_update_kernel<3>", "float")),
    ("storage_kernels::backward_update_kernel<double, 5>"
     "(storage_kernels::Operands<double>, storage_kernels::BasisDesc)",
     ("storage_kernels::backward_update_kernel<5>", "double")),
    ("storage_kernels::backward_update_kernel<3>"
     "(storage_kernels::Operands, storage_kernels::BasisDesc)",
     ("storage_kernels::backward_update_kernel<3>", "float")),
    ("void storage_kernels::forward_sim_kernel<float, 5>"
     "(storage_kernels::FwdOperands<float>, storage_kernels::BasisDesc)",
     ("void storage_kernels::forward_sim_kernel<5>", "float")),
    ("storage_kernels::path_sim_kernel<double, 4, true>(const unsigned int *, const double *)",
     ("storage_kernels::path_sim_kernel<4, true>", "double")),
    ("storage_kernels::backward_f64::backward_update_f64_kernel"
     "(storage_kernels::backward_f64::Operands, storage_kernels::BasisDesc)",
     ("storage_kernels::backward_f64::backward_update_f64_kernel", "float")),
    ("void storage_kernels::path_sim_f64_kernel<3, false>(unsigned int const*, double const*, "
     "double const*, double*, long long, unsigned int, int, int, int)",
     ("void storage_kernels::path_sim_f64_kernel<3, false>", "double")),
], ids=["K1-float", "K1-double", "K1-untemplated", "K2-float", "K3-double", "no-template",
        "K3-f64-kernel"])
def test_kernel_key_strips_the_element_type(demangled, key):
    assert kernel_key(demangled) == key


def test_float_and_double_instantiations_get_apart_keys():
    f32 = kernel_key("storage_kernels::forward_sim_kernel<float, 3>(FwdOperands<float>)")
    f64 = kernel_key("storage_kernels::forward_sim_kernel<double, 3>(FwdOperands<double>)")
    parent = kernel_key("storage_kernels::forward_sim_kernel<3>(FwdOperands, BasisDesc)")
    assert f32 == parent and f64[0] == f32[0] and f64 != f32


@pytest.mark.parametrize("layout,expected", [
    (("backward_update.cu", "forward_sim.cu", "path_sim.cu", "backward_update_f64.cu",
      "forward_sim_f64.cu"), ("backward_update_f64.cu", "forward_sim_f64.cu", "path_sim.cu")),
    (("backward_update.cu", "forward_sim.cu", "path_sim.cu"),
     ("backward_update.cu", "forward_sim.cu", "path_sim.cu")),
], ids=["split-f64-sources", "templated"])
def test_f64_sources_take_the_parents_float64_kernels(tmp_path, layout, expected):
    for name in layout:
        (tmp_path / name).write_text("")
    assert f64_sources(tmp_path) == expected


def test_ulps_apart_counts_last_bit_differences():
    a = torch.tensor([1.0, -2.5, 0.0, 3.0], dtype=torch.float64)
    b = torch.from_numpy(np.nextafter(a.numpy(), np.inf))
    b[0] = a[0]
    b[3] = np.nextafter(np.nextafter(3.0, np.inf), np.inf)
    share, worst = ulps_apart(a, b)
    assert share == 0.25 and worst == 2
    assert ulps_apart(a, a.clone()) == (1.0, 0)
