"""The planted-fault and design-variant tools stay in step with the kernel
sources: each fault's edit applies exactly once to its file in a copy of the
tree and leaves the checkout's source as it was, and each variant's edits
(grouped GEMM K4-K6, flash K1-K3) find their anchors exactly once.
(Running the tools needs the card: ``python3 -m
veomni_tpu_torch.tools.fault_check``, ``... .gmm_variants``,
``... .flash_variants``.)"""

import os

import pytest

from veomni_tpu_torch.tools import fault_check as fc
from veomni_tpu_torch.tools import flash_variants as fv
from veomni_tpu_torch.tools import gmm_variants as gv


@pytest.mark.parametrize("fault", fc.FAULTS, ids=[f.name for f in fc.FAULTS])
def test_fault_plants_once_in_a_copy(fault, tmp_path):
    with open(os.path.join(fc.REPO, fault.source)) as f:
        original = f.read()
    fc.make_copy(str(tmp_path))
    fc.plant(str(tmp_path), fault)
    with open(os.path.join(tmp_path, fault.source)) as f:
        planted = f.read()
    assert original.count(fault.anchor) == 1
    assert planted == original.replace(fault.anchor, fault.replacement) != original
    assert os.path.exists(os.path.join(tmp_path, "chip_smoke.py"))
    with open(os.path.join(fc.REPO, fault.source)) as f:
        assert f.read() == original
    with pytest.raises(RuntimeError, match="anchor"):
        fc.plant(str(tmp_path), fault._replace(anchor="no such line"))


@pytest.mark.parametrize("name", list(gv.VARIANTS), ids=list(gv.VARIANTS))
def test_design_variant_edits_apply_once(name):
    """The design variants timed by ``gmm_variants`` stay in step with the
    source: each edit's anchor occurs exactly once."""
    with open(os.path.join(fc.REPO, fc.GMM_SOURCE)) as f:
        text = f.read()
    for anchor, _ in gv.VARIANTS[name][1]:
        assert text.count(anchor) == 1, anchor


@pytest.mark.parametrize("name", list(fv.VARIANTS), ids=list(fv.VARIANTS))
def test_flash_variant_edits_apply_once(name):
    """The K1-K3 variants timed by ``flash_variants`` stay in step with the
    source: each edit's anchor occurs exactly once."""
    with open(os.path.join(fc.REPO, fc.FLASH_SOURCE)) as f:
        text = f.read()
    for anchor, _ in fv.VARIANTS[name][1]:
        assert text.count(anchor) == 1, anchor
