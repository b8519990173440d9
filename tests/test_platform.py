"""Platform plumbing: the persistent compile-cache rule and the on-card
smoke script's behaviour off the card."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import vettore_tpu

ROOT = Path(__file__).resolve().parent.parent


def test_compile_cache_dir_honours_the_variable():
    assert vettore_tpu._compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/somewhere/else"}) is None


def test_compile_cache_dir_defaults_to_the_checkout():
    assert vettore_tpu._compile_cache_dir({}) == str(ROOT / ".jax_cache")


def _cache_dir_in_child(env_extra, drop=()):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", *drop)}
    env.update(env_extra, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c",
         "import vettore_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_variable_set_is_used(tmp_path):
    assert _cache_dir_in_child(
        {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) == str(tmp_path)


def test_compile_cache_variable_unset_uses_checkout():
    assert _cache_dir_in_child({}) == str(ROOT / ".jax_cache")


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json_lines(text):
    out = []
    for line in text.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            pass
    return out


@pytest.mark.parametrize("argv", [[], ["--devices", "4"], ["--only", "flat"]])
def test_chip_smoke_exits_nonzero_without_gpu(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        _load_chip_smoke().main(argv)
    assert exc.value.code not in (0, None)
    assert not _json_lines(capsys.readouterr().out)


@pytest.mark.parametrize("phase", ["flat", "kernel_timing", "funnel_quantized",
                                   "ivf", "flat_small", "maxsim"])
def test_chip_smoke_rehearsal_passes_without_a_result(phase, capsys):
    """``--rehearse`` runs a phase at a tiny size on the CPU (the kernel in
    the interpreter) with every check live, then exits 3 and prints no
    result line."""
    with pytest.raises(SystemExit) as exc:
        _load_chip_smoke().main(["--rehearse", "--only", phase])
    out = capsys.readouterr().out
    assert exc.value.code == 3
    assert not _json_lines(out)
    assert "rehearsal passed" in out


def test_chip_smoke_rejects_unknown_phase():
    with pytest.raises(SystemExit) as exc:
        _load_chip_smoke().main(["--rehearse", "--only", "nope"])
    assert exc.value.code == 2
