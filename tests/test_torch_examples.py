"""The port's examples (``examples/torch_*.py``) on the CPU, against the
reference's examples of the same names.

Each port example runs as a script with ``--device cpu`` and must exit 0.
The reference's ``priority_serving.py``, ``seap_deadlines.py`` and
``observability.py`` print deterministic queue results: served orders and
tiers, per-tier admission waits, relaxed-serve counts, the Seap
directory's boundaries, EDF start steps and deadline stats, the metrics
rows, the overflow ramp and the served Prometheus lines.  They run once,
in one subprocess at 4 forced devices (the port's examples run 4 shards
by default), and every line they print must appear in the port's output,
but the two lines that carry a wall time or a file path ("[device]" and
"[trace]").  ``serve_queue.py`` serves a model whose random weights the
two packages draw differently: the port's run is checked for its queue
results alone (every request served, FIFO admission).
"""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("observability", "priority_serving", "seap_deadlines",
            "serve_queue")
COMPARED = ("priority_serving", "seap_deadlines", "observability")
UNTIMED = ("[device]", "[trace]")   # wall-clock and path lines

REF_SCRIPT = r"""
import runpy, sys
for name in sys.argv[1:]:
    print(f"### {name}", flush=True)
    runpy.run_path(f"{ROOT}/examples/{name}.py", run_name="__main__")
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    out = {}
    tmp = tmp_path_factory.mktemp("examples")
    for name in EXAMPLES:
        args = ["--device", "cpu"]
        if name == "observability":
            args += ["--trace", str(tmp / "trace.json")]
        out[name] = subprocess.run(
            [sys.executable, os.path.join(ROOT, "examples",
                                          f"torch_{name}.py"), *args],
            cwd=tmp, env=_env(), capture_output=True, text=True,
            timeout=300)
    return out


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_cpu(port_runs, name):
    proc = port_runs[name]
    assert proc.returncode == 0, proc.stderr
    text = proc.stdout
    if name == "serve_queue":
        assert "served 10/10 requests" in text, text
        assert "queue FIFO admission order preserved: True" in text, text
    elif name == "observability":
        assert "6 wave rows drained" in text and "(7 exchanges for 6 " \
            "waves)" in text, text
    else:
        assert text.count("== §") == 3, text


def test_examples_match_reference(port_runs, tmp_path):
    env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT.replace("{ROOT}", ROOT),
         *COMPARED], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr
    sections = proc.stdout.split("### ")[1:]
    assert [s.splitlines()[0] for s in sections] == list(COMPARED)
    for sec in sections:
        name, *lines = sec.splitlines()
        port = port_runs[name].stdout.splitlines()
        want = [ln for ln in lines if ln.strip()
                and not ln.lstrip().startswith(UNTIMED)]
        assert len(want) >= 8, (name, lines)
        missing = [ln for ln in want if ln not in port]
        assert not missing, (name, missing, port)
