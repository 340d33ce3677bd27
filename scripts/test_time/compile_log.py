"""pytest plugin: for every test, each XLA compile request (the program's
name, its seconds, and whether JAX's persistent cache served it), the
test's wall and CPU seconds, and the seconds spent in the JAX package's
``reps.Atom.rho``; one JSON line a test in ``$COMPILE_LOG_<worker>.jsonl``.

    COMPILE_LOG=/tmp/cl PYTHONPATH=scripts/test_time \\
        python -m pytest tests/test_torch_td3.py -p compile_log

Summarize with ``compile_log_sum.py /tmp/cl``.
"""
import json
import os
import time

import pytest

_events = []
_rho = [0.0]
_out = os.environ.get("COMPILE_LOG", "compile_log")


def _install():
    from jax._src import compiler
    if getattr(compiler, "_compile_log_patched", False):
        return
    orig = compiler.compile_or_get_cached
    orig_hit = compiler.log_persistent_cache_hit
    state = {"hit": False}

    def hit(name, key):
        state["hit"] = True
        return orig_hit(name, key)

    def compile_or_get_cached(backend, computation, *a, **k):
        from jax._src.lib.mlir import ir
        name = ir.StringAttr(
            computation.operation.attributes["sym_name"]).value
        state["hit"] = False
        t0 = time.perf_counter()
        out = orig(backend, computation, *a, **k)
        _events.append((name, time.perf_counter() - t0, state["hit"]))
        return out
    compiler.compile_or_get_cached = compile_or_get_cached
    compiler.log_persistent_cache_hit = hit
    compiler._compile_log_patched = True
    from gym_rotor_tpu.models.emlp import reps as jreps
    orig_rho = jreps.Atom.rho

    def rho(self, g):
        t0 = time.perf_counter()
        try:
            return orig_rho(self, g)
        finally:
            _rho[0] += time.perf_counter() - t0
    jreps.Atom.rho = rho


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    _install()
    _events.clear()
    _rho[0] = 0.0
    t0, c0 = time.perf_counter(), time.process_time()
    yield
    rec = dict(test=item.nodeid, wall=time.perf_counter() - t0,
               cpu=time.process_time() - c0, rho=_rho[0],
               events=list(_events))
    worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
    with open(f"{_out}_{worker}.jsonl", "a") as f:
        f.write(json.dumps(rec) + "\n")
