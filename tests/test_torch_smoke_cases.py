"""The case lists that ``chip_smoke.py`` and ``tools/kernel_times.py`` read on
the card name what exists, checked on the CPU: the K4 case that each K4 body's
summary entry (and its one plain-version timing) reads, the K3 case that
each K3 mode's entry reads, the K1 / K2 case that each GEMV entry reads, each
``--kernels prefill`` case's preset, layer cut and prompt, and the sources
that each ``--variant`` edits."""

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


K3_NAMES = sorted(n for n in chip_smoke.SUMMARY_CASE if n.startswith("flash_decode"))


@pytest.mark.parametrize("name", K3_NAMES)
def test_k3_summary_case_is_one_k3_case(name):
    cases = [case for mode, case, *_ in kt.K3_CASES
             if chip_smoke.k3_name(mode) == name and chip_smoke.SUMMARY_CASE[name] in case]
    assert len(cases) == 1, (name, cases)


@pytest.mark.parametrize("name", ["gemv_int8", "gemv_nib4c"])
def test_gemv_summary_case_is_one_gemv_case(name):
    """Across both of ``gemv_cases``' lists (``seen`` carries the plain
    timing from one to the other) and at M 1, where the ``matmul``
    yardstick is timed."""
    cases = [(case, M) for kern, case, *_, M in (*kt.GEMV_CASES, *kt.OSS_GEMV_CASES)
             if kern == name and chip_smoke.SUMMARY_CASE[name] in case]
    assert len(cases) == 1 and cases[0][1] == 1, (name, cases)


@pytest.mark.parametrize("variant", sorted(kt.GEMV_VARIANTS))
def test_gemv_variant_edits_apply(variant, tmp_path):
    """Each variant's texts are in the kernel source once, and the copy
    ``--variant`` times holds the edited source and the package."""
    from pathlib import Path

    root = Path(kernels.__file__).resolve().parents[1]
    pkg = root / "llama_cpp_gfx906_tpu_torch"
    (tmp_path / "llama_cpp_gfx906_tpu_torch").symlink_to(pkg)
    out = kt.variant_root(tmp_path, variant) / "llama_cpp_gfx906_tpu_torch"
    for rel, text, planted in kt.GEMV_VARIANTS[variant]:
        assert (pkg / rel).read_text().count(text) == 1
        assert planted in (out / rel).read_text()
    assert (out / "kernels.py").read_bytes() == (pkg / "kernels.py").read_bytes()


@pytest.mark.parametrize("preset,n_layers,tokens", kt.PREFILL_CASES)
def test_prefill_case_fits(preset, n_layers, tokens):
    assert preset in PRESETS
    assert n_layers is None or 0 < n_layers <= PRESETS[preset][0]
    assert 0 < tokens < 4096  # the engine's max_seq in ``prefill_times``


def test_every_group_builds_known_sources():
    assert "prefill" in kt.GROUPS
    for names in kt.GROUPS.values():
        assert set(names) <= set(kernels.SOURCES)
