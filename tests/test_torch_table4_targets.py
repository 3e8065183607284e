"""PyTorch port: EfficientNet on VecUnit and ResMLP on VTA against the JAX reference.

The pattern of ``test_torch_table4.py`` (reference-trained parameters, 8
points, per-point logits within 0.05·max|ideal| of the reference's, equal
classes and accuracies) for the apps that reach the last two targets:
EfficientNet on FlexASR + HLSCNN + VecUnit (ideal, ila-16, fused-16; 6
vecunit, 4 hlscnn and 2 flexasr offloads) and the ResMLP program on VTA
(ideal, ila, kernel; 7 vta_gemm, 4 vta_add, 2 vta_relu). Within the port,
fused equals ila and VTA's kernel column equals its ila column bit for bit.
EfficientNet's port-vs-reference deviation reaches about 0.04·max|ideal|:
VecUnit's grid scales differ by an ulp between the packages (see
``test_torch_vecunit.py``) and the next conv's fixed-point rounding turns
that into whole 2^-8 steps.
"""
import pytest
from test_torch_table4 import _row, check_bit_identical, check_column, column_params

from repro_torch.core import ir

KEYS = ("efficientnet", "resmlp_vta")


@pytest.mark.parametrize("key,column", column_params(KEYS))
def test_column_matches_reference_per_point(key, column):
    check_column(key, column)


@pytest.mark.parametrize("key", KEYS)
def test_fast_columns_bit_identical_to_ila(key):
    check_bit_identical(key)


def test_offloads():
    assert _row("efficientnet")[1].offloads == {"flexasr": 2, "hlscnn": 4, "vecunit": 6,
                                                "vta": 0}
    ops = [x.op for x in ir.postorder(_row("resmlp_vta")[1].program) if isinstance(x, ir.Call)]
    assert {op: ops.count(op) for op in ("vta_gemm", "vta_add", "vta_relu")} == \
        {"vta_gemm": 7, "vta_add": 4, "vta_relu": 2}
