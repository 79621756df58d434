"""roms_tpu_torch's command line, on the CPU: `cases`, `run` from a YAML
file and from flags, the module entry point in a subprocess, the cases
the package does not have, and no fallback to the CPU without a card."""

import os
import subprocess
import sys

import pytest
import torch

from roms_tpu_torch.__main__ import main
from roms_tpu_torch.io.netcdf import read_history
from roms_tpu_torch.utils.yamlcfg import build_from_dict

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cases(capsys):
    assert main(["cases"]) == 0
    assert capsys.readouterr().out.split() == [
        "basin", "benchmark", "bio_toy", "bl_test", "canyon3d", "channel",
        "channel_neck", "double_gyre", "estuary", "flt_test", "grav_adj",
        "inlet_test", "kelvin", "lab_canyon", "lake_signell", "lmd_test",
        "mixed_layer", "overflow", "riverplume", "riverplume2", "seamount",
        "sed_test1", "sed_toy", "shoreface", "soliton", "test_chan",
        "test_head", "upwelling", "weddell", "windbasin", "file"]


def test_cases_registered():
    """`python -m roms_tpu_torch cases` lists the regional cases."""
    res = subprocess.run([sys.executable, "-m", "roms_tpu_torch", "cases"],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert {"kelvin", "estuary", "riverplume"} <= set(res.stdout.split())


def test_run_estuary_on_the_cpu(capsys):
    """The published ESTUARY_TEST (200x3x20) runs two steps on the CPU."""
    assert main(["run", "--case", "estuary", "--nsteps", "2", "--device",
                 "cpu", "--ninfo", "1"]) == 0
    out = capsys.readouterr().out
    assert "roms_tpu_torch: case=estuary grid=200x3x20" in out
    assert out.count("KE=") == 2


def test_run_yaml_writes_history(tmp_path, capsys):
    ycfg = tmp_path / "run.yaml"
    ycfg.write_text(
        "case: upwelling\nnsteps: 3\n"
        "config: {Lm: 12, Mm: 14, N: 4, ndtfast: 6}\n"
        f"output: {{his_file: {tmp_path}/his.nc, nhis: 3, ninfo: 1,"
        f" rst_file: {tmp_path}/rst, nrst: 3}}\n")
    assert main(["run", str(ycfg), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "roms_tpu_torch: case=upwelling grid=12x14x4" in out
    assert len([ln for ln in out.splitlines() if "KE=" in ln]) == 3
    assert "3d time stepping" in out
    h = read_history(str(tmp_path / "his.nc"))
    assert h["zeta"].shape == (1, 14, 12)
    assert (tmp_path / "rst_0000003.pt").exists()


def test_module_entry_point():
    res = subprocess.run(
        [sys.executable, "-m", "roms_tpu_torch", "run", "--case",
         "upwelling", "--nsteps", "2", "--device", "cpu", "--ninfo", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-2000:]
    assert "roms_tpu_torch: case=upwelling grid=41x80x16" in res.stdout
    assert res.stdout.count("KE=") == 2


@pytest.mark.parametrize("case", ["no_such_case"])
def test_cases_not_ported_raise(case):
    with pytest.raises(NotImplementedError,
                       match=f"not ported: case '{case}'"):
        build_from_dict({"case": case, "grid_file": "g.nc"}, device="cpu")


@pytest.mark.parametrize("case", ["flt_test", "shoreface"])
def test_run_the_last_cases(case, capsys):
    """FLT_TEST and SHOREFACE, which the registry once lacked, run two
    steps at their published sizes through the command line."""
    assert main(["run", "--case", case, "--nsteps", "2", "--device", "cpu",
                 "--ninfo", "1"]) == 0
    out = capsys.readouterr().out
    assert f"case={case}" in out and out.count("KE=") == 2


def test_run_soliton_exits_2(capsys):
    """A 2-D-only case has no run driver: the CLI exits 2 and names
    step_2d_only, as roms_tpu's does."""
    assert main(["run", "--case", "soliton", "--device", "cpu"]) == 2
    assert "roms_tpu_torch.ops.step2d.step_2d_only" in \
        capsys.readouterr().err


def test_run_without_a_card_fails():
    """The device defaults to the card; without one the run fails with
    torch's error instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises((AssertionError, RuntimeError)):
        main(["run", "--case", "upwelling", "--nsteps", "1"])
