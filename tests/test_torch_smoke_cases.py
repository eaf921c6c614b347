"""The case lists that ``chip_smoke.py`` and ``tools/kernel_times.py`` read on
the card name what exists, checked on the CPU: the K4 case that each K4 body's
summary entry (and its one plain-version timing) reads, and each
``--kernels prefill`` case's preset, layer cut and prompt."""

import pytest

import chip_smoke
from llama_cpp_gfx906_tpu_torch import kernels
from llama_cpp_gfx906_tpu_torch.tools import kernel_times as kt
from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import PRESETS

K4_NAMES = sorted(n for n in chip_smoke.SUMMARY_CASE if n.startswith("flash_attention"))


@pytest.mark.parametrize("name", K4_NAMES)
def test_k4_summary_case_is_one_k4_case(name):
    cases = [case for mode, case, *_ in kt.K4_CASES
             if "flash_attention" + (f"_{mode}" if mode else "") == name
             and chip_smoke.SUMMARY_CASE[name] in case]
    assert len(cases) == 1, (name, cases)


@pytest.mark.parametrize("preset,n_layers,tokens", kt.PREFILL_CASES)
def test_prefill_case_fits(preset, n_layers, tokens):
    assert preset in PRESETS
    assert n_layers is None or 0 < n_layers <= PRESETS[preset][0]
    assert 0 < tokens < 4096  # the engine's max_seq in ``prefill_times``


def test_every_group_builds_known_sources():
    assert "prefill" in kt.GROUPS
    for names in kt.GROUPS.values():
        assert set(names) <= set(kernels.SOURCES)
