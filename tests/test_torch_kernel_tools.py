"""The measuring and gating helpers around the tensor-core kernels, on the
CPU: ``kernel_bits.py --compare`` reports the bf16 recurrence's cases as
changed (their sum order moved to the tensor cores), the fast dot's as
changed where they lie within the f32 gate of their plain version, and
fails on any other difference; ``chip_smoke.py``'s SASS reader counts the
HMMA instructions of each ``lstm_cluster_kernel`` instantiation, and of
every kernel of the grid head's sources, and its gates want them in the
bf16 recurrence and the fast dot's tensor-core kernels and nowhere
else."""

import types

import pytest
import torch

import chip_smoke
from icl_torch.tools import kernel_bits

BF16_CASE = "recurrence bf16 2 32 64 200 residuals"


@pytest.mark.parametrize("moved,rc", [
    (BF16_CASE, 0), ("recurrence 2 32 64 200 residuals", 1), ("K5 x", 1),
    ("grid_head 8 16 16 800 4", 1)])
def test_compare_holds_all_but_the_bf16_recurrence_to_equal_bits(
        tmp_path, capsys, moved, rc):
    one = torch.ones(4)
    first = {BF16_CASE: (one.bfloat16(),), moved: (one,), "K5 x": (one,)}
    second = dict(first)
    bumped = one.clone()
    bumped[0] = 1.0078125                 # one bf16 unit of 1 above
    second[moved] = (bumped.to(first[moved][0].dtype),)
    torch.save(first, tmp_path / "p.pt")
    torch.save(second, tmp_path / "c.pt")
    assert kernel_bits.main(["--compare", str(tmp_path / "p.pt"),
                             str(tmp_path / "c.pt")]) == rc
    out = capsys.readouterr().out
    if rc == 0:
        assert "differ: []" in out
        assert (f"{BF16_CASE}: changed, held to BF16_REC_ULPS "
                f"(chip_smoke.py); 1.00 bf16 units") in out
    else:
        assert f"differ: ['{moved}']" in out


def test_the_sass_reader_counts_hmma_per_instantiation(monkeypatch):
    sass = """
        Function : _ZN51_GLOBAL__N__0c0b0325_18_lstm_recurrence_cu_a657387219lstm_cluster_kernelI13__nv_bfloat16Li8ELb1ELi2EEEvPKT_PKhS4_PS2_S7_S7_S7_iii
        /*0a10*/  HMMA.16816.F32.BF16 R8, R12, R16, RZ ;
        /*0a20*/  HMMA.16816.F32.BF16 R20, R24, R28, RZ ;
        Function : _ZN51_GLOBAL__N__0c0b0325_18_lstm_recurrence_cu_a657387219lstm_cluster_kernelIfLi16ELb0ELi1EEEvPKT_PKhS3_PS1_S6_S6_S6_iii
        /*0a10*/  FFMA R1, R2, R3, R4 ;
        Function : lstm_cluster_kernel<__nv_bfloat16, 16, true, 1>(...)
        /*0a10*/  HMMA.16816.F32.BF16 R8, R12, R16, RZ ;
        Function : _ZN51_GLOBAL__N__0c0b0325_18_lstm_recurrence_cu_a657387219lstm_cluster_kernelIfLi8ELb1ELi1EEEvPKT_PKhS3_PS1_S6_S6_S6_iii
        /*0a10*/  HMMA.1688.F32.TF32 R8, R12, R16, RZ ;
        Function : _ZN12_GLOBAL__N_111some_kernelEv
        /*0a10*/  HMMA.16816.F32.BF16 R8, R12, R16, RZ ;
"""
    monkeypatch.setattr(chip_smoke._build, "nvcc", lambda: "/cuda/bin/nvcc")
    seen = []

    def run(cmd, **kw):
        seen.append(cmd)
        return types.SimpleNamespace(stdout=sass)

    monkeypatch.setattr(chip_smoke.subprocess, "run", run)
    assert chip_smoke._recurrence_mma("lib.so") == {
        ("bf16", 8, True, 2): 2, ("f32", 16, False, 1): 0,
        ("bf16", 16, True, 1): 1, ("f32", 8, True, 1): 1}
    assert seen == [["/cuda/bin/cuobjdump", "-sass", "lib.so"]]


@pytest.mark.parametrize("change,ok", [
    ({}, True),
    ({("f32", 8, True, 1): 4}, False),      # an f32 instantiation on mma
    ({("f32", 16, True, 1): 4}, False),
    ({("f32", 16, False, 1): 4}, False),
    ({("bf16", 8, True, 1): 0}, False),     # a bf16 one without
    ({("bf16", 16, True, 2): 0}, False),
    ({("f32", 8, False, 1): 0}, False),     # an instantiation not expected
    ({("bf16", 8, True, 1): None}, False)])  # one missing
def test_the_sass_gate_wants_hmma_in_the_bf16_mode_alone(change, ok):
    mma = {k: (8 if want else 0)
           for k, want in chip_smoke.RECURRENCE_MMA.items()}
    for k, n in change.items():
        if n is None:
            del mma[k]
        else:
            mma[k] = n
    assert chip_smoke._mma_as_expected(mma) is ok


FAST_CASE = "grid_head bf16dot 64 16 16 800 4"


@pytest.mark.parametrize("moved,plain,rc", [
    (1e-6, True, 0),       # within 1e-5 * max(1, max |plain|) of its plain
    (1e-3, True, 1),       # beyond it
    (1e-6, False, 1)])     # no plain version to hold it to
def test_compare_holds_a_changed_fast_dot_to_its_plain_version(
        tmp_path, capsys, moved, plain, rc):
    one = torch.ones(4)
    first = {FAST_CASE: (one,), FAST_CASE + kernel_bits.PLAIN: (one,),
             "K5 x": (one,)}
    second = dict(first)
    second[FAST_CASE] = (one + moved,)
    if not plain:
        del first[FAST_CASE + kernel_bits.PLAIN]
        del second[FAST_CASE + kernel_bits.PLAIN]
    torch.save(first, tmp_path / "p.pt")
    torch.save(second, tmp_path / "c.pt")
    assert kernel_bits.main(["--compare", str(tmp_path / "p.pt"),
                             str(tmp_path / "c.pt")]) == rc
    out = capsys.readouterr().out
    if rc == 0:
        assert "differ: []" in out
        assert f"{FAST_CASE}: changed, max|d| 9.537e-07 from its plain " \
               f"version (the f32 gate 1.000e-05)" in out
    else:
        assert f"differ: ['{FAST_CASE}']" in out


HEAD_SASS = """
        Function : _ZN37_GLOBAL__N__6f0b1c2d_12_grid_head_cu_9a8b7c6d24grid_head_bf16dot_kernelILi16ELb1EEEvN8icl_head7DotArgsE
        /*0a10*/  HMMA.16816.F32.BF16 R8, R12, R16, R8 ;
        Function : _ZN37_GLOBAL__N__6f0b1c2d_12_grid_head_cu_9a8b7c6d24grid_head_bf16dot_kernelILi16ELb0EEEvN8icl_head7DotArgsE
        /*0a10*/  HMMA.16816.F32.BF16 R8, R12, R16, R8 ;
        Function : grid_head_bf16dot_kernel<8, true>(icl_head::DotArgs)
        /*0a10*/  HMMA.16816.F32.BF16 R8, R12, R16, R8 ;
        Function : _ZN37_GLOBAL__N__6f0b1c2d_12_grid_head_cu_9a8b7c6d24grid_head_bf16dot_kernelILi8ELb0EEEvN8icl_head7DotArgsE
        /*0a10*/  HMMA.16816.F32.BF16 R8, R12, R16, R8 ;
        Function : _ZN37_GLOBAL__N__6f0b1c2d_12_grid_head_cu_9a8b7c6d24grid_head_bf16fma_kernelILi4ELb1ELi4EEEvN8icl_head8HeadArgsE
        /*0a10*/  FFMA R1, R2, R3, R4 ;
        Function : _ZN37_GLOBAL__N__6f0b1c2d_12_grid_head_cu_9a8b7c6d16grid_head_kernelILi4ELb1ELi4EEEvN8icl_head8HeadArgsE
        /*0a10*/  FFMA R1, R2, R3, R4 ;
"""


def test_the_sass_reader_counts_hmma_per_kernel(monkeypatch):
    monkeypatch.setattr(chip_smoke._build, "nvcc", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(chip_smoke.subprocess, "run",
                        lambda cmd, **kw: types.SimpleNamespace(
                            stdout=HEAD_SASS))
    assert chip_smoke._sass_hmma("lib.so") == {
        "grid_head_bf16dot_kernelILi16ELb1E": 1,
        "grid_head_bf16dot_kernelILi16ELb0E": 1,
        "grid_head_bf16dot_kernel<8, true>(icl_head::DotArgs)": 1,
        "grid_head_bf16dot_kernelILi8ELb0E": 1,
        "grid_head_bf16fma_kernelILi4ELb1ELi4E": 0,
        "grid_head_kernelILi4ELb1ELi4E": 0}


@pytest.mark.parametrize("source,change,ok", [
    ("grid_head", {}, True),
    ("grid_head", {"grid_head_bf16dot_kernelILi8ELb0E": 0}, False),
    ("grid_head", {"grid_head_bf16fma_kernelILi4ELb1ELi4E": 2}, False),
    ("grid_head", {"grid_head_kernelILi4ELb1ELi4E": 1}, False),
    ("grid_head", {"grid_head_bf16dot_kernelILi8ELb0E": None}, False),
    ("grid_head_train", {}, False),     # the training source has no HMMA
    ("affinity_rank", {}, False)])      # another source's instantiations
def test_the_head_sass_gate_wants_hmma_in_the_fast_dot_alone(
        source, change, ok):
    hmma = {"grid_head_bf16dot_kernelILi16ELb1E": 8,
            "grid_head_bf16dot_kernelILi16ELb0E": 8,
            "grid_head_bf16dot_kernelILi8ELb1E": 4,
            "grid_head_bf16dot_kernelILi8ELb0E": 4,
            "grid_head_bf16fma_kernelILi4ELb1ELi4E": 0,
            "grid_head_kernelILi4ELb1ELi4E": 0}
    for k, n in change.items():
        if n is None:
            del hmma[k]
        else:
            hmma[k] = n
    if source == "grid_head_train":
        hmma = {"head_fwd_kernelILi0ELi4ELb1ELi4ELb0EE": 0,
                "head_bwd_kernelILi4ELb0EE": 3}
    assert chip_smoke._head_mma_as_expected(source, hmma) is ok
