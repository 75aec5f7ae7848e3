"""The port's multi-process proving (distaff_torch/dist_setup.py and the
mesh over the ranks of a job, distaff_torch/parallel/) on the CPU over
gloo, held against the JAX package's initialize_distributed and
parallel/mesh.py, and against single-device proving.

One module-scoped fixture starts every job of the file at once, each rank a
subprocess under a timeout of its own and a rendezvous timeout, each job on
a free port of its own, and the tests read the ranks' results: the golden
program on 4 ranks (and dryrun_step over them), on 3 ranks (which split
nothing), streamed on 2 ranks (and dryrun_step over them), the tool
(distaff_torch/tools/multihost_prove.py) on one process and then, against
that baseline, on 2 ranks, and one process of a 2-process job whose peer
never comes.  The JAX package's dryrun_step is held through its
register-sharded LDE on its virtual CPU mesh and host arithmetic over it,
as tests/test_torch_mesh.py holds the single-process one (the JAX
sharded_composition's XLA:CPU compile alone would take this file's time).
"""

import hashlib
import importlib.util
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from distaff_tpu import verify as jax_verify
from distaff_tpu.math import field as jax_field
from distaff_tpu.math import field_jax as fj
from distaff_tpu.parallel import mesh as jax_mesh
from distaff_tpu.stark import serde as jax_serde

import distaff_torch
from distaff_torch import assembly, dist_setup, ProgramInputs
from distaff_torch.stark import serde

ROOT = Path(__file__).resolve().parent.parent
M = jax_field.M
GOLDEN_SHA256 = "876d9f49cddbe11a3b360c04245d3b29712b6309a1eb446af835b123c729c842"
GOLDEN_LEN = 12926
GOLDEN_SRC = "begin push.3 push.5 add end"
SPLIT_STAGES = ("transition", "boundaries", "composition", "fri_fold", "constraint_intt",
                "constraint_lde", "merkle_subtrees")
# seconds: a rank's rendezvous and exchanges, a rank's whole run, and the
# missing peer's rendezvous
RENDEZVOUS_TIMEOUT = 60
RANK_TIMEOUT = 120
MISSING_PEER_TIMEOUT = 3
TOOL_LOG2_TRACE = 6

# a rank's work: the golden proof (its bytes and the stages it recorded)
# and dryrun_step over the first n ranks for each n of "dryrun"
RANK_CODE = f"""
import json, sys
import torch
torch.set_num_threads(1)
import distaff_torch
from distaff_torch import assembly, ProgramInputs, ProofOptions
from distaff_torch.math import field_torch as ft
from distaff_torch.parallel import mesh as pm, mesh_stages
from distaff_torch.stark import serde

tasks, result = json.loads(sys.argv[1]), {{}}
if tasks.get("golden"):
    program = assembly.compile({GOLDEN_SRC!r})
    outputs, proof = distaff_torch.execute(program, ProgramInputs.none(), 1,
                                           ProofOptions(16, 10, 2), device="cpu")
    result["proof"] = serde.serialize(proof).hex()
    result["outputs"] = outputs
    result["recorded"] = {{k: [a, list(v)] for k, (a, v) in
                          mesh_stages.RECORDED_SHARDINGS.items()}}
for n in tasks.get("dryrun", []):
    composed = pm.dryrun_step(n, device="cpu")
    result[f"dryrun{{n}}"] = [int(v) for v in ft.to_ints(composed)]
with open(sys.argv[2], "w") as fh:
    json.dump(result, fh)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**values):
    env = {k: v for k, v in os.environ.items()
           if k not in ("DISTAFF_COORDINATOR", "DISTAFF_DISTRIBUTED", "DISTAFF_NUM_PROCESSES",
                        "DISTAFF_PROCESS_ID", "DISTAFF_MESH_DEVICES", "DISTAFF_STREAM_LDE")}
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT), env.get("PYTHONPATH")]))
    env["OMP_NUM_THREADS"] = "1"
    env.update({k: str(v) for k, v in values.items()})
    return env


# every process the fixture started: it kills those still running at its end
STARTED = []


class Processes:
    """The processes of one job, started at once."""

    def __init__(self, command, ranks, timeout=RANK_TIMEOUT, **env):
        port = _free_port()
        self.timeout = timeout
        self.start = time.monotonic()
        env = {"DISTAFF_COORDINATOR": f"127.0.0.1:{port}",
               "DISTAFF_RENDEZVOUS_TIMEOUT": RENDEZVOUS_TIMEOUT, **env}
        self.procs = [subprocess.Popen(
            command(rank), cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(DISTAFF_PROCESS_ID=rank, **env)) for rank in range(ranks)]
        STARTED.extend(self.procs)

    def wait(self):
        """[(return code, stdout, stderr)] a rank, and the job's seconds; a
        rank past its timeout is killed and fails the job."""
        out = []
        for proc in self.procs:
            left = max(1.0, self.timeout - (time.monotonic() - self.start))
            try:
                stdout, stderr = proc.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                proc.kill()
                stdout, stderr = proc.communicate()
                stderr += f"\n(killed after {self.timeout} s)"
            out.append((proc.returncode, stdout, stderr))
        return out, time.monotonic() - self.start


def _rank_job(tmp, name, ranks, tasks, **env):
    results = [tmp / f"{name}-{rank}.json" for rank in range(ranks)]
    job = Processes(lambda rank: [sys.executable, "-c", RANK_CODE, json.dumps(tasks),
                            str(results[rank])],
              ranks, DISTAFF_NUM_PROCESSES=ranks, **env)
    return job, results


def _tool(*args):
    return [sys.executable, "-m", "distaff_torch.tools.multihost_prove", str(TOOL_LOG2_TRACE),
            "--bench", "--device", "cpu", *args]


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every job of the file, run at once: name -> (the ranks' results, or
    the processes' (return code, stdout, stderr), and the job's seconds)."""
    try:
        yield _run_jobs(tmp_path_factory.mktemp("jobs"))
    finally:
        for proc in STARTED:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def _run_jobs(tmp):
    rank_jobs = {
        "four": _rank_job(tmp, "four", 4, {"golden": True, "dryrun": [4]},
                          DISTAFF_MESH_DEVICES=4),
        "three": _rank_job(tmp, "three", 3, {"golden": True}, DISTAFF_MESH_DEVICES=3),
        "two_streamed": _rank_job(tmp, "two", 2, {"golden": True, "dryrun": [2]},
                                  DISTAFF_MESH_DEVICES=2, DISTAFF_STREAM_LDE=1),
    }
    baseline = tmp / "baseline.json"
    tool_one = subprocess.Popen(_tool("--out", str(baseline)), cwd=ROOT, env=_env(),
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    STARTED.append(tool_one)
    missing = Processes(lambda rank: [sys.executable, "-c", "import distaff_torch"], 1,
                  DISTAFF_NUM_PROCESSES=2, DISTAFF_RENDEZVOUS_TIMEOUT=MISSING_PEER_TIMEOUT)

    done = {}
    stdout, stderr = tool_one.communicate(timeout=RANK_TIMEOUT)
    assert tool_one.returncode == 0, stderr
    done["tool_one"] = json.loads(stdout.strip().splitlines()[-1])
    done["tool_two"] = Processes(lambda rank: _tool("--baseline", str(baseline)), 2,
                           DISTAFF_NUM_PROCESSES=2).wait()
    done["missing"] = missing.wait()
    for name, (job, results) in rank_jobs.items():
        procs, seconds = job.wait()
        for rank, (code, _, err) in enumerate(procs):
            assert code == 0, f"job {name}, rank {rank}:\n{err[-4000:]}"
        done[name] = [json.loads(path.read_text()) for path in results]
    return done


# ------------------------------------------------------------------------------------------------
# initialize_distributed against the JAX package's
# ------------------------------------------------------------------------------------------------

def _jax_setup():
    """A fresh copy of distaff_tpu/jax_setup.py (importing the package would
    run its configure(), which joins a job by the same environment)."""
    spec = importlib.util.spec_from_file_location(
        "jax_setup_under_test", ROOT / "distaff_tpu" / "jax_setup.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("env", [{}, {"DISTAFF_COORDINATOR": "127.0.0.1:1"},
                                 {"DISTAFF_COORDINATOR": "127.0.0.1:1",
                                  "DISTAFF_NUM_PROCESSES": "2"},
                                 {"DISTAFF_COORDINATOR": "127.0.0.1:1",
                                  "DISTAFF_PROCESS_ID": "0"}])
def test_initialize_distributed_rules_match_jax(monkeypatch, env):
    for key in ("DISTAFF_COORDINATOR", "DISTAFF_DISTRIBUTED", "DISTAFF_NUM_PROCESSES",
                "DISTAFF_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    # the JAX function's CPU branch sets an XLA flag of this process first
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    jax_setup = _jax_setup()
    if not env:
        assert jax_setup.initialize_distributed() is False
        assert dist_setup.initialize_distributed() is False
        assert dist_setup.job() is None
        return
    with pytest.raises(RuntimeError) as jax_error:
        jax_setup.initialize_distributed()
    with pytest.raises(RuntimeError) as port_error:
        dist_setup.initialize_distributed()
    assert str(port_error.value) == str(jax_error.value)
    assert "all three are required" in str(port_error.value)
    # both raise before any rendezvous, and neither marks the process joined
    assert jax_setup._DISTRIBUTED is False
    assert dist_setup._DISTRIBUTED is False and dist_setup.job() is None


def test_a_rank_asked_for_the_card_without_one_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    job = dist_setup.Job(store=None, rank=0, world=1, local_rank=0, timeout=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        job.bind("cuda")
    assert job.backend is None


def test_missing_peer_raises_within_its_timeout(jobs):
    ((code, _, stderr),), seconds = jobs["missing"]
    assert code != 0
    assert "DistStoreError" in stderr, stderr[-2000:]
    assert seconds < RANK_TIMEOUT / 2


# ------------------------------------------------------------------------------------------------
# dryrun_step across ranks against the JAX package's
# ------------------------------------------------------------------------------------------------

@pytest.mark.parametrize("ranks,job", [(2, "two_streamed"), (4, "four")])
def test_dryrun_step_across_ranks_matches_jax(jobs, ranks, job):
    # dryrun_step's data (the JAX package's seeds): its register-sharded LDE
    # on the JAX package's virtual mesh of as many devices, and the row-split
    # composition over it in host arithmetic
    rng = np.random.default_rng(0)
    values = rng.integers(0, 2**63, size=(16, 64)).astype(object)
    jax_lde = jax_mesh.sharded_lde(fj.from_ints(values), 16, jax_mesh.make_mesh(ranks))
    rng = np.random.default_rng(1)
    w1, w2 = (rng.integers(0, 2**63, size=(16,)) for _ in range(2))
    cols = fj.to_ints(np.asarray(jax_lde))
    root = jax_field.get_root_of_unity(cols.shape[1])
    want = []
    for j in range(cols.shape[1]):
        a1 = sum(int(w) * int(v) for w, v in zip(w1, cols[:, j])) % M
        a2 = sum(int(w) * int(v) for w, v in zip(w2, cols[:, j])) % M
        x = jax_field.exp(root, j)
        want.append((a1 * jax_field.inv(jax_field.sub(x, 123456789))
                     + a2 * jax_field.inv(jax_field.sub(x, 987654321))) % M)
    for rank, result in enumerate(jobs[job]):
        assert result[f"dryrun{ranks}"] == want, rank


# ------------------------------------------------------------------------------------------------
# proofs across ranks: the single-device bytes on every rank
# ------------------------------------------------------------------------------------------------

def _golden_bytes(result):
    blob = bytes.fromhex(result["proof"])
    assert len(blob) == GOLDEN_LEN and hashlib.sha256(blob).hexdigest() == GOLDEN_SHA256
    return blob


def test_golden_proof_on_four_ranks(jobs):
    program = assembly.compile(GOLDEN_SRC)
    for rank, result in enumerate(jobs["four"]):
        blob = _golden_bytes(result)
        assert distaff_torch.verify(program.hash, [], result["outputs"],
                                    serde.deserialize(blob)), rank
        for stage in SPLIT_STAGES:
            axis, slots = result["recorded"][stage]
            assert slots == [f"rank{r}:cpu" for r in range(4)], (rank, stage)
    assert jax_verify(program.hash, ProgramInputs.none().get_public_inputs(),
                      jobs["four"][0]["outputs"],
                      jax_serde.deserialize(bytes.fromhex(jobs["four"][0]["proof"])))


def test_three_ranks_split_nothing(jobs):
    # 3 ranks divide no power of two: no stage splits (ntt_sharded.fits,
    # mesh_stages.transition_fits, fold_fits, subtree_fits), and every rank
    # proves the rest whole on its home
    for result in jobs["three"]:
        _golden_bytes(result)
        assert result["recorded"] == {}


def test_streamed_golden_proof_on_two_ranks(jobs):
    for result in jobs["two_streamed"]:
        _golden_bytes(result)
        for stage in ("stream_ntt", "composition", "fri_fold"):
            assert result["recorded"][stage][1] == ["rank0:cpu", "rank1:cpu"], stage


def test_tool_bench_line_on_two_ranks_matches_its_baseline(jobs):
    procs, _ = jobs["tool_two"]
    for rank, (code, stdout, stderr) in enumerate(procs):
        assert code == 0, f"rank {rank}:\n{stderr[-4000:]}"
        assert stdout.startswith(f"# process {rank}: 2 process(es), 2 global device(s), "
                                 f"backend gloo on cpu"), stdout
    line = json.loads(procs[0][1].strip().splitlines()[-1])
    assert line["proof_matches_baseline"] is True
    assert line["proof_sha256"] == jobs["tool_one"]["proof_sha256"]
    assert (line["processes"], line["mesh_devices"], line["platform"]) == (2, 2, "cpu")
    assert jobs["tool_one"]["processes"] == 1 and jobs["tool_one"]["mesh_devices"] == 1
    assert set(line["stages_s"]) == {"trace_lde", "trace_commit", "constraint_eval",
                                     "constraint_poly", "constraint_commit", "composition",
                                     "fri", "queries", "proof_object"}
    assert line["scaling_efficiency"] > 0 and line["speedup_vs_baseline"] > 0
