"""REAL multi-process ``jax.distributed`` execution (VERDICT r2 next #1).

Launches 2 local processes, each with 4 virtual CPU devices, connected
through a localhost coordinator — the first time ``initialize_distributed``
and ``_device_grid``'s process-major assumption execute with
``jax.process_count() > 1`` (all prior multi-host evidence was
single-process virtual-mesh compilation). The workers run
``expv_sharded`` (global row mesh, incl. the two-pass form) and
``expv_batched`` (hosts=data × devices=shard mesh) across the process
boundary and compare against host scipy oracles
(tests/multiproc_worker.py); this launcher additionally cross-checks
that the replicated scalars agree bit-identically between processes.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("_NPROC,_DEVS", [(2, 4), (4, 2)])
def test_multi_process_distributed_execution(tmp_path, _NPROC, _DEVS):
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "multiproc_worker.py")
    procs = []
    outs = []
    for pid in range(_NPROC):
        out = tmp_path / f"proc{pid}.json"
        outs.append(out)
        cfg = {"port": port, "nproc": _NPROC, "pid": pid,
               "devs_per_proc": _DEVS, "out": str(out)}
        env = dict(os.environ)
        # Rebuild XLA_FLAGS from scratch: the conftest's 8-device flag
        # must not leak a conflicting per-process device count.
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={_DEVS}"
        env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
        procs.append(subprocess.Popen(
            [sys.executable, worker, json.dumps(cfg)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fails = []
    logs = []
    for pid, p in enumerate(procs):
        try:
            stdout, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, _ = p.communicate()
            fails.append((pid, "timeout"))
        logs.append(stdout)
        if p.returncode != 0:
            fails.append((pid, p.returncode))
    assert not fails, "\n\n".join(
        f"--- proc {pid} ({why}) ---\n{log[-4000:]}"
        for (pid, why), log in zip(fails, logs))

    res = [json.loads(out.read_text()) for out in outs]
    for r in res:
        assert r["process_count"] == _NPROC, r
        assert r["ndev"] == _NPROC * _DEVS, r
        assert r["local_ndev"] == _DEVS, r
        assert r["expv_rel_err"] < 1e-10, r
        assert r["expv_two_pass_rel_err"] < 1e-10, r
        assert r["batched_rel_err"] < 1e-9, r
    # replicated scalars must agree bit-identically across processes
    for r in res[1:]:
        assert r["expv_norm"] == res[0]["expv_norm"], res
        assert r["expv_dot"] == res[0]["expv_dot"], res
