"""The port's example scripts (``examples/torch_*.py``) end to end on the
CPU (``--cpu``), at small sizes, each in a subprocess, as
``tests/test_models_extra.py:93-145`` runs the reference's scripts.

All the scripts start at once (a module fixture) and each case reads its
own: the exit code and the JSONL records the script wrote with
``--metrics-path``. The pod-scale script runs as two processes under
``python -m torch.distributed.run`` with ``--distributed`` and must write
the scaling harness's ``scaling`` event for two ranks and convergence
events with the discrete split-R̂ fields.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

SMALL = ["--n-chains", "8", "--n-warmup", "60", "--n-samples", "120"]
CASES = {
    "torch_run_hybrid_chain": SMALL,
    "torch_run_gaussian_grid": ["--rows", "4", "--cols", "4"] + SMALL,
    "torch_run_friends_smokers": ["--n-people", "8", "--vi-iters", "400"],
    "torch_run_lds_smc": ["--T", "8", "--smc-particles", "512",
                          "--smc-temps", "20"],
    "torch_run_image_denoise": ["--rows", "5", "--cols", "5",
                                "--engine", "hmc"] + SMALL,
    "torch_run_robot_map": ["--vi-iters", "300"],
    "torch_demo": [],
    "torch_run_pod_scale": ["--distributed", "--fast", "--n-people", "60",
                            "--n-chains", "16", "--n-warmup", "8",
                            "--n-samples", "8", "--vi-iters", "200"],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("examples")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                        "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    procs = {}
    for name, extra in CASES.items():
        cmd = [sys.executable, f"{name}.py", "--cpu", "--metrics-path",
               str(out / f"{name}.jsonl")] + extra
        if name == "torch_run_pod_scale":
            cmd = ([sys.executable, "-m", "torch.distributed.run",
                    "--standalone", "--nproc-per-node", "2"]
                   + cmd[1:] + ["--checkpoint-dir", str(out / "pod_ckpt")])
        procs[name] = subprocess.Popen(
            cmd, cwd=REPO / "examples", env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    res = {}
    try:
        for name, p in procs.items():
            text = p.communicate(timeout=300)[0]
            path = out / f"{name}.jsonl"
            recs = ([json.loads(line) for line in path.read_text().splitlines()]
                    if path.exists() else [])
            res[name] = (p.returncode, text, recs)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return res


def _finite(*vals):
    return all(v is not None and math.isfinite(v) for v in vals)


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_script_runs_on_the_cpu(runs, name):
    rc, text, recs = runs[name]
    assert rc == 0, text[-3000:]
    by = {}
    for r in recs:
        by.setdefault(r["event"], []).append(r)
    if name == "torch_run_pod_scale":
        scal = by.get("scaling")
        assert scal and scal[0]["devices"] == 2, by.keys()
        assert 0.0 < scal[0]["efficiency"]
        conv = by.get("convergence")
        assert conv and all("rhat_disc_max" in c and c["n_disc_monitored"] > 0
                            for c in conv)
        prod = by["production_run"][0]
        assert _finite(prod["rhat_disc_max"], prod["mode_swap_accept"])
        assert {q["method"] for q in by["query"]} == {"lifted_vi", "hmc"}
        assert by["checkpoint"] and (
            Path(by["checkpoint"][0]["path"]) / "vi").is_dir()
        return
    res = by["result"]
    assert all(r["wall_s"] > 0 for r in res)
    if name == "torch_demo":
        assert [r["engine"] for r in res] == ["nuts", "hmc", "vi", "smc",
                                              "lbp", "epbp", "mws"]
        assert all(_finite(r["mean_err_max"], r["disc_err_max"])
                   for r in res[:-1])
        assert res[-1]["map_d_equal"]
    elif name == "torch_run_friends_smokers":
        assert res[0]["cancer_err"] < 0.05  # σ(1.2) in closed form
    elif name == "torch_run_lds_smc":
        assert _finite(res[0]["mean_err_avg"], res[0]["log_z_err"])
        assert by["smc_run"][0]["n_temps_used"] > 0
    elif name == "torch_run_image_denoise":
        assert _finite(res[0]["mse_obs"], res[0]["mse_est"])
    elif name == "torch_run_robot_map":
        assert 0 <= res[0]["correct"] <= res[0]["n_unlabeled"]
    else:
        assert _finite(res[0]["mean_err_max"])
