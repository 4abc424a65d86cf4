"""Host-side helpers of ``tools/kernel_turns.py`` (no GPU needed).

``kernel_key`` names a kernel of a disassembly so that the float32
instantiation of a kernel templated on its element type meets the float32
kernel of an earlier source of the same name, and a float64 instantiation
meets nothing of float32.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from kernel_turns import kernel_key  # noqa: E402

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
], ids=["K1-float", "K1-double", "K1-untemplated", "K2-float", "K3-double", "no-template"])
def test_kernel_key_strips_the_element_type(demangled, key):
    assert kernel_key(demangled) == key


def test_float_and_double_instantiations_get_apart_keys():
    f32 = kernel_key("storage_kernels::forward_sim_kernel<float, 3>(FwdOperands<float>)")
    f64 = kernel_key("storage_kernels::forward_sim_kernel<double, 3>(FwdOperands<double>)")
    parent = kernel_key("storage_kernels::forward_sim_kernel<3>(FwdOperands, BasisDesc)")
    assert f32 == parent and f64[0] == f32[0] and f64 != f32
