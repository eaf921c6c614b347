"""Every planted fault of ``chip_smoke.py --plant-faults`` still finds its text.

``plant_faults`` copies the port and replaces one text per edit in each copy;
it refuses a text that is not in its file exactly once, but only on the card.
This holds the same on the CPU for every fault of ``FAULTS``, ``NIB4_FAULTS``
and ``K4_FAULTS`` (through ``fault_edits``), so that an edit of a kernel
source that moves a fault's text shows before a chip run."""

from pathlib import Path

import pytest

import chip_smoke

PKG = Path(chip_smoke.__file__).resolve().parent / chip_smoke.PKG
EDITS = [(fault, i, *edit)
         for fault in (*chip_smoke.FAULTS, *chip_smoke.NIB4_FAULTS, *chip_smoke.K4_FAULTS)
         for i, edit in enumerate(chip_smoke.fault_edits(fault))]


def test_every_fault_group_has_edits():
    faults = {fault for fault, *_ in EDITS}
    assert set(chip_smoke.K4_FAULTS) <= faults and set(chip_smoke.NIB4_FAULTS) <= faults
    assert {chip_smoke.fault_group(f) for f in faults} == {"k3", "k4", "k6", "nib4"}


@pytest.mark.parametrize("fault,i,rel,text,planted", EDITS,
                         ids=[f"{fault}-{i}" for fault, i, *_ in EDITS])
def test_fault_text_occurs_once(fault, i, rel, text, planted):
    body = (PKG / rel).read_text()
    assert body.count(text) == 1, f"{fault}: its text is in {rel} {body.count(text)} times"
    assert planted != text
