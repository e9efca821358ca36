"""The planted-fault tool for the grouped-GEMM kernels stays in step with
their source: each fault's edit applies exactly once to a copy of the tree
and leaves the checkout's source as it was. (Running the faulted copies
needs the card: ``python3 -m veomni_tpu_torch.tools.gmm_fault_check``.)"""

import os

import pytest

from veomni_tpu_torch.tools import gmm_fault_check as fc


@pytest.mark.parametrize("fault", fc.FAULTS, ids=[f.name for f in fc.FAULTS])
def test_fault_plants_once_in_a_copy(fault, tmp_path):
    with open(os.path.join(fc.REPO, fc.SOURCE)) as f:
        original = f.read()
    fc.make_copy(str(tmp_path))
    fc.plant(str(tmp_path), fault)
    with open(os.path.join(tmp_path, fc.SOURCE)) as f:
        planted = f.read()
    assert original.count(fault.anchor) == 1
    assert planted == original.replace(fault.anchor, fault.replacement) != original
    assert os.path.exists(os.path.join(tmp_path, "chip_smoke.py"))
    with open(os.path.join(fc.REPO, fc.SOURCE)) as f:
        assert f.read() == original
    with pytest.raises(RuntimeError, match="anchor"):
        fc.plant(str(tmp_path), fault._replace(anchor="no such line"))
