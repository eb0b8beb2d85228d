"""Every text variant of ``lqp_py_tpu_torch.kernel_variants`` still applies
to the committed CUDA sources: each string it replaces is found (no nvcc
needed), so an edit to a kernel that moves an anchor fails here and not
first on the card."""

import pytest

from lqp_py_tpu_torch import kernel_variants as kv
from lqp_py_tpu_torch.ops.kernels import _build

CASES = [(kernel, name) for kernel, variants in kv.VARIANTS.items()
         for name in variants if name != "base"]


@pytest.mark.parametrize("kernel,name", CASES,
                         ids=[f"{k}-{n}" for k, n in CASES])
def test_variant_anchors_found(kernel, name):
    texts = kv.variant_sources(kernel, name)
    assert texts, f"{kernel}/{name} edits nothing"
    for fname, text in texts.items():
        assert text != (_build.CSRC / fname).read_text(), fname


def test_missing_anchor_raises(tmp_path):
    (tmp_path / "gemv_early_exit.cu").write_text("// no anchors here\n")
    with pytest.raises(RuntimeError, match="not in gemv_early_exit.cu"):
        kv.variant_sources("gemv", "no_streaming", tmp_path)
