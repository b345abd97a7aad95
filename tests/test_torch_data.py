"""The port's input pipeline: ``Stage`` and ``Pipeline`` are copies of
the reference's ``data/pipeline.py`` (pinned to its code), and they run
as it documents: host stages on the worker threads, device stages and
``device_put_fn`` on the consumer's thread, one worker keeping the
source's order, ``autotune`` leaving the pipeline running with the best
setting, ``stop`` joining the workers."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import precision  # noqa: E402
from repro_torch.data import Pipeline, Stage, SyntheticLM  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402

from test_torch_kernels import _defs  # noqa: E402


@pytest.fixture(scope="module")
def jpipeline():
    pytest.importorskip("jax")
    from repro.data import pipeline
    return pipeline


def test_copied_pipeline_matches_the_original(jpipeline):
    assert _defs(tpipeline) == _defs(jpipeline)


def test_one_worker_yields_the_sources_batches_in_order():
    want = iter(SyntheticLM(500, 3, 24, seed=5, structured=True))
    pipe = Pipeline(SyntheticLM(500, 3, 24, seed=5, structured=True), [],
                    n_threads=1, prefetch=2).start()
    try:
        for _ in range(12):
            got, w = next(pipe), next(want)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(got[k], w[k])
    finally:
        pipe.stop()


def test_stages_run_where_they_are_placed():
    """Host stages on a worker thread, device stages and the put on the
    caller's; ``lazy_promote`` at the last host stage promotes only what
    it must."""
    seen = {}

    def tag(where):
        def fn(item):
            seen.setdefault(where, set()).add(threading.get_ident())
            return dict(item, **{where: True})
        return fn

    def promote(item):
        item = tag("host")(item)
        x = torch.from_numpy(item["tokens"]).to(torch.int32)
        return dict(item, x=precision.lazy_promote(x, torch.int64),
                    y=precision.lazy_promote(x, torch.int32))

    def put(item):
        seen.setdefault("put", set()).add(threading.get_ident())
        return dict(item, put=True)

    stages = [Stage("aug", promote, "host"),
              Stage("norm", tag("device"), "device")]
    pipe = Pipeline(SyntheticLM(100, 2, 8), stages, n_threads=2,
                    device_put_fn=put).start()
    try:
        items = [next(pipe) for _ in range(6)]
    finally:
        pipe.stop()
    me = threading.get_ident()
    assert seen["device"] == seen["put"] == {me}
    assert me not in seen["host"]
    assert pipe.placements == {"aug": "host", "norm": "device"}
    for it in items:
        assert it["host"] and it["device"] and it["put"]
        assert it["x"].dtype == torch.int64 and it["y"].dtype == torch.int32
    x = torch.zeros(2, dtype=torch.bfloat16)
    assert precision.lazy_promote(x, torch.bfloat16) is x


def test_autotune_keeps_a_setting_and_leaves_the_pipeline_running():
    stages = [Stage("either", lambda it: it, "either"),
              Stage("host", lambda it: it, "host")]
    pipe = Pipeline(SyntheticLM(100, 2, 8), stages, n_threads=1).start()
    try:
        out = pipe.autotune(lambda item: None, candidates_threads=(1, 2),
                            samples=3)
        assert out["n_threads"] in (1, 2)
        assert pipe.n_threads == out["n_threads"]
        assert out["placements"]["either"] in ("host", "device")
        assert pipe.placements["either"] == out["placements"]["either"]
        assert pipe.placements["host"] == "host"
        assert len(out["all"]) == 4 and out["samples_per_sec"] > 0
        assert len(pipe._threads) == pipe.n_threads
        assert all(t.is_alive() for t in pipe._threads)
        assert set(next(pipe)) == {"tokens", "labels"}
    finally:
        pipe.stop()


def test_stop_joins_the_workers_and_a_finite_source_ends():
    pipe = Pipeline(SyntheticLM(100, 2, 8), [], n_threads=3,
                    prefetch=1).start()
    threads = list(pipe._threads)
    next(pipe)
    pipe.stop()
    assert not any(t.is_alive() for t in threads) and pipe._threads == []
    src = [{"i": i} for i in range(3)]
    pipe = Pipeline(src, [], n_threads=1).start()
    assert [it["i"] for it in pipe] == [0, 1, 2]
    pipe.stop()
