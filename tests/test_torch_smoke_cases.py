"""The case lists that ``chip_smoke.py`` and ``tools/kernel_times.py`` read on
the card name what exists, checked on the CPU: the K4 case that each K4 body's
summary entry (and its one plain-version timing) reads, the K3 case that
each K3 mode's entry reads, the K1 / K2 case that each GEMV entry reads, each
``--kernels prefill`` case's preset, layer cut and prompt, the sources
that each ``--variant`` edits, and the K6 / K7 trace's reading."""

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


@pytest.mark.parametrize("variant", sorted(kt.VARIANTS))
def test_gemv_variant_edits_apply(variant, tmp_path):
    """Each variant's texts (K1/K2's and K6/K7's) are in the kernel source
    once, and the copy ``--variant`` times holds the edited source and the
    package."""
    from pathlib import Path

    root = Path(kernels.__file__).resolve().parents[1]
    pkg = root / "llama_cpp_gfx906_tpu_torch"
    (tmp_path / "llama_cpp_gfx906_tpu_torch").symlink_to(pkg)
    out = kt.variant_root(tmp_path, variant) / "llama_cpp_gfx906_tpu_torch"
    for rel, text, planted in kt.VARIANTS[variant]:
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


def test_trace_sizes_match_the_kernel():
    """``decode_trace`` reads the buffer that csrc/decode_stream.cu's
    ``TRACE`` build fills: the same barrier and block counts."""
    from pathlib import Path

    src = (Path(kernels.__file__).resolve().parent / "csrc" / "decode_stream.cu").read_text()
    bars, blocks = kt.TRACE_BARS, kt.TRACE_BLOCKS
    assert bars % 7 == 0 and f"TRACE_BARS = 7 * {bars // 7}," in src
    assert f"TRACE_BLOCKS = {blocks}," in src
    assert len(kt.TRACE_PHASES) == 7 and "constexpr bool TRACE = false;" in src


@pytest.mark.parametrize("layers,blocks,run", [(1, 1, 1), (2, 3, 2), (18, 5, 5)])
def test_trace_summary_sums_each_phase(layers, blocks, run):
    """``trace_summary`` against a plain loop over the blocks that ran and
    the barriers they passed, on stamps drawn from a seed (blocks past
    ``run`` and barriers past the launch's are left 0, as the kernel leaves
    them)."""
    import numpy as np

    rng = np.random.default_rng(layers * 100 + blocks)
    n = 7 * layers
    rows = np.zeros((blocks + 2, 1 + 2 * kt.TRACE_BARS), np.int64)
    release = np.cumsum(rng.integers(1000, 5000, n)) + 10**6
    for b in range(run):
        t = 10**6 - int(rng.integers(1, 500))
        rows[b, 0] = t
        for i in range(n):
            rows[b, 1 + 2 * i] = int(rng.integers(t + 1, release[i]))  # arrival
            t = int(release[i]) + int(rng.integers(0, 50))  # release, block by block
            rows[b, 2 + 2 * i] = t
    got = kt.trace_summary(rows)
    assert got["blocks"] == run
    live = rows[:run]
    assert got["step_us"] == pytest.approx(
        (live[:, 2 * n].max() - live[:, 0].min()) / 1e3)
    for k, name in enumerate(kt.TRACE_PHASES):
        work = wait = span = bar = 0.0
        for i in range(k, n, 7):
            for b in range(run):
                prev = live[b, 0] if i == 0 else live[b, 2 * i]
                work += live[b, 1 + 2 * i] - prev
                wait += live[b, 2 + 2 * i] - live[b, 1 + 2 * i]
            last_prev = live[:, 0].min() if i == 0 else live[:, 2 * i].max()
            span += live[:, 2 + 2 * i].max() - last_prev
            bar += live[:, 2 + 2 * i].max() - live[:, 1 + 2 * i].max()
        assert got[name]["work_us"] == pytest.approx(work / 1e3 / run)
        assert got[name]["wait_us"] == pytest.approx(wait / 1e3 / run)
        assert got[name]["span_us"] == pytest.approx(span / 1e3)
        assert got[name]["barrier_us"] == pytest.approx(bar / 1e3)
