"""What the harness loads and when it refuses to run."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_the_harness_loads_no_jax_and_no_jax_package():
    """The harness and every entry, generator and pattern module, the
    port with them, in a fresh interpreter."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import importlib, pkgutil\n"
            "import lapbench.harness, lapbench.limits\n"
            "for kind in ('entries', 'generators', 'patterns'):\n"
            "    pkg = importlib.import_module('lapbench.' + kind)\n"
            "    for m in pkgutil.iter_modules(pkg.__path__):\n"
            "        importlib.import_module(pkg.__name__ + '.' + m.name)\n"
            "top = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(top & {'jax', 'jaxlib', 'flax', 'sslap_tpu'}))\n"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    # the port is loaded, under its own name, which is not the JAX package's
    code2 = code.replace("print(sorted", "print('sslap_tpu_torch' in top, "
                         "sorted")
    out = subprocess.run([sys.executable, "-c", code2], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.stdout.strip() == "True []"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from lapbench import harness
    monkeypatch.setitem(sys.modules, "sslap_tpu_torchish", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]


def test_no_result_without_a_card():
    """Here there is no CUDA device: the run exits non-zero and prints
    nothing on standard output."""
    out = subprocess.run(
        [sys.executable, "lapbench/run.py", "--workload", "sparse1M.cold",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout == ""


def test_no_result_from_the_benchmark_files_alone(tmp_path):
    """A directory with only BENCHMARK.json and lapbench/: the program is
    missing, so the run fails before it prints anything."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "lapbench", tmp_path / "lapbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "lapbench/run.py", "--workload", "sparse1M.cold",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert out.stdout == ""
    assert "sslap_tpu_torch" in out.stderr
