"""Sweep runner: synthetic spec parsing, log emission, CSV production."""
import os

from linkpred_tpu.bench.sweep import _parse_synthetic, main


def test_parse_synthetic():
    name, g = _parse_synthetic("rmat:8:4")
    assert name == "rmat_s8_e4"
    assert g.n == 256 and g.m > 0


def test_sweep_end_to_end(tmp_path, capsys):
    rc = main([
        "--synthetic", "rmat:8:4", "--out-dir", str(tmp_path),
        "--metrics", "cn", "--degrees", "0",
        "--repeat-batch", "1", "--repeat-method", "1",
        "--deletions-begin", "0.05", "--deletions-end", "0.05",
        "--cap", "16384",
    ])
    assert rc == 0
    assert (tmp_path / "sweep.log").exists()
    csv = tmp_path / "rmat_s8_e4.csv"
    assert csv.exists()
    lines = csv.read_text().strip().split("\n")
    assert len(lines) >= 2
    assert "predictLinksCommonNeighborsJax0" in lines[1]


def test_sweep_resume_skips_done(tmp_path, capsys):
    args = [
        "--synthetic", "rmat:8:4", "--out-dir", str(tmp_path),
        "--metrics", "cn", "--degrees", "0",
        "--repeat-batch", "1", "--repeat-method", "1",
        "--deletions-begin", "0.05", "--deletions-end", "0.05",
        "--cap", "16384", "--resume",
    ]
    assert main(args) == 0
    n_lines = len((tmp_path / "sweep.log").read_text().splitlines())
    assert main(args) == 0  # second run skips the graph
    out = capsys.readouterr().out
    assert "skipping rmat_s8_e4" in out
    assert len((tmp_path / "sweep.log").read_text().splitlines()) == n_lines


def test_parse_synthetic_ppart():
    name, g = _parse_synthetic("ppart:4:20")
    assert name == "ppart_c4_s20"
    assert g.n == 80 and g.m > 0
