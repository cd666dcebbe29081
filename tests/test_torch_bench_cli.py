"""`python -m vectorindex_tpu_torch.bench` against the JAX package's CLI
(`python -m vectorindex_tpu.bench`) at the same arguments on tiny corpora,
on the CPU (--device cpu).

Tolerances: the JSON keys equal the JAX CLI's exactly; flat search is exact
in both packages, so its recall is equal (1.0); the other indices' recall
and every time are reported, not compared (other quantizers and graphs).
"""

import json

import pytest
import torch

from vectorindex_tpu.bench import __main__ as jcli
from vectorindex_tpu_torch.bench import __main__ as cli

torch.set_num_threads(1)

TINY = ["--n", "600", "--d", "16", "--k", "5", "--queries", "12", "--ivf-nlist", "8",
        "--pq-m", "4", "--hnsw-m", "8", "--hnsw-efc", "32"]


def _keys(obj):
    """The nested key structure of a JSON payload."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(v) for v in obj]
    return type(obj).__name__ if isinstance(obj, bool) else "value"


def _run_jax(argv, capsys):
    jcli.main(argv)
    return json.loads(capsys.readouterr().out)


def _run_port(argv, capsys):
    payload = cli.main([*argv, "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == payload  # printed as returned
    return payload


@pytest.mark.parametrize("index", ["flat", "ivf", "ivfpq", "hnsw"])
def test_suite_keys_equal_the_reference(index, capsys):
    argv = [*TINY, "--index", index]
    want = _run_jax(argv, capsys)
    got = _run_port(argv, capsys)
    assert _keys(got) == _keys(want)
    assert [r["index"] for r in got] == [index]
    for field in ("n", "d", "k", "queries", "metric", "params"):
        assert got[0][field] == want[0][field]
    assert got[0]["qps"] > 0 and 0.0 <= got[0]["recall_avg"] <= 1.0
    if index == "flat":
        assert got[0]["recall_avg"] == want[0]["recall_avg"] == 1.0


def test_vb_envelope_and_out_file(tmp_path, capsys):
    out = tmp_path / "run.json"
    got = _run_port([*TINY, "--index", "flat,ivf", "--vb", "--out", str(out)], capsys)
    assert json.loads(out.read_text()) == got
    assert set(got) == {"schema_version", "created_at", "host", "results"}
    assert got["host"]["devices"] == ["cpu"] and got["host"]["torch"] == torch.__version__
    assert [r["index"] for r in got["results"]] == ["flat", "ivf"]


@pytest.mark.parametrize("sweep, index", [("nprobe=1,8", "ivf"), ("efs=16,64", "hnsw")])
def test_sweep(sweep, index, capsys):
    knob, values = sweep.split("=")
    got = _run_port([*TINY, "--n", "1200", "--index", index, "--sweep", sweep], capsys)
    assert [p[knob] for p in got] == [int(v) for v in values.split(",")]
    for p in got:
        assert set(p) == {"index", knob, "recall_at_k", "qps", "ms_per_query"}
        assert p["index"] == index and p["qps"] > 0
    # the index reads the reassigned config: more probes or a wider beam
    # find at least as many true neighbours
    assert got[-1]["recall_at_k"] >= got[0]["recall_at_k"]
    if index == "ivf":
        assert got[-1]["recall_at_k"] == 1.0  # nprobe = nlist: every list scanned


def test_microbench(capsys):
    got = _run_port(["--microbench", "--n", "4096", "--d", "32", "--batch", "8",
                     "--trials", "3"], capsys)
    assert got["kernel"] == "l2sqr_block" and got["device"] == "cpu"
    assert (got["n"], got["d"], got["batch"]) == (4096, 32, 8)
    assert got["ms_per_pass"] > 0 and got["corpus_gb_per_s"] > 0
    assert got["bound_ms"] == pytest.approx(4096 * 32 * 2 / 3.35e12 * 1e3)
    assert got["kernel_counters"]["kernel.l2sqr_block.calls"] == 1 + 3 * 3


def test_the_cli_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: nothing to refuse")
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        cli.main([*TINY, "--index", "flat"])
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        cli.main(["--microbench", "--n", "64", "--d", "8"])
