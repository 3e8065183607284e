"""PyTorch port: continuous-batching co-sim serving (``core/serving.py``).

The assertions of ``tests/test_serving.py`` on the port (CPU), and the port
held to the reference: the same program, seed and request ids served by the
reference's ``CosimServer`` and by the port's give bit-identical outputs
(FlexASR's ILA is bit-exact across the packages), and coalesced results equal
serial ones within the port.
"""
import sys
import threading

import numpy as np
import pytest
import torch

import repro.accel  # noqa: F401  (registers the reference's targets)
from repro.core import ir as jir
from repro.core.serving import CosimServer as JServer
from repro_torch.core import ila, ir
from repro_torch.core.codegen import Executor
from repro_torch.core.serving import (
    DONE, REJECT_BACKLOG, REJECT_QUEUE_FULL, REJECT_SHUTDOWN, CosimServer, _to_host,
    percentiles_ms, request_rng,
)
from repro_torch.launch import serve


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Thousands of small ops: with several test workers on one host,
    torch's default intra-op thread pool per worker oversubscribes the
    cores and slows them by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_program(I=16, O=8, seed=0, ir_mod=ir):
    """relu(fasr_linear(x, w, b)): one accelerator call + a host epilogue."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((O, I)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((O,)) * 0.1).astype(np.float32)
    expr = ir_mod.call(
        "relu",
        ir_mod.call("fasr_linear", ir_mod.Var("x", (4, I)), ir_mod.Var("w", w.shape),
                    ir_mod.Var("b", b.shape)),
    )
    return expr, {"w": w, "b": b}


def _server(**kw):
    kw.setdefault("engine", "pipelined")
    kw.setdefault("pipeline_chunk", 2)
    kw.setdefault("device", "cpu")
    srv = CosimServer(**kw)
    expr, params = _tiny_program()
    srv.add_program("tiny", expr, params)
    return srv


def _burst(srv, n, batch=1):
    """Submit ``n`` requests before start(), then serve them all."""
    handles = [srv.submit("tiny", batch=batch) for _ in range(n)]
    try:
        srv.start(warmup=1, warm_batch=2)
        outs = {h.id: h.result(timeout=300) for h in handles}
    finally:
        srv.close(drain=True)
    return handles, outs


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------


def test_served_outputs_equal_the_reference_server_bit_for_bit():
    srv = _server(seed=3, max_batch=8, queue_depth=32)
    handles, outs = _burst(srv, 6)
    ref = JServer(engine="pipelined", pipeline_chunk=2, seed=3, max_batch=8, queue_depth=32)
    expr, params = _tiny_program(ir_mod=jir)
    ref.add_program("tiny", expr, params)
    ref_handles = [ref.submit("tiny", batch=1) for _ in range(6)]
    try:
        ref.start(warmup=1, warm_batch=2)
        want = {h.id: h.result(timeout=300) for h in ref_handles}
    finally:
        ref.close(drain=True)
    assert sorted(outs) == sorted(want)
    for rid, got in outs.items():
        assert all(isinstance(o, np.ndarray) for o in got)
        np.testing.assert_array_equal(srv.request_envs("tiny", rid, 1)[0]["x"],
                                      ref.request_envs("tiny", rid, 1)[0]["x"])
        for g, w in zip(got, want[rid]):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"request {rid}")
    assert srv.summary()["served"] == ref.summary()["served"] == 6


@pytest.mark.parametrize("engine", ["pipelined", "fused"])
@pytest.mark.parametrize("coalesce,overlap", [(True, True), (False, False)])
def test_engine_and_schedule_do_not_change_outputs(engine, coalesce, overlap):
    """Every engine and schedule serves the compiled engine's serial bits."""
    srv = _server(seed=5, max_batch=8, queue_depth=32, engine=engine,
                  coalesce=coalesce, overlap=overlap)
    handles, outs = _burst(srv, 5, batch=2)
    serial = Executor("ila", engine="compiled", device="cpu")
    expr, _params = _tiny_program()
    for h in handles:
        want = serial.run_many(expr, srv.request_envs("tiny", h.id, 2))
        for g, w in zip(outs[h.id], want):
            np.testing.assert_array_equal(g, w.numpy() if torch.is_tensor(w) else w)
    assert (srv.summary()["coalesced_max"] > 1) == coalesce


# ---------------------------------------------------------------------------
# tests/test_serving.py on the port
# ---------------------------------------------------------------------------


def test_coalesced_equals_serial_bit_exact():
    srv = _server(seed=3, max_batch=8, queue_depth=32)
    handles, outs = _burst(srv, 6)
    assert any(h.coalesced_with > 0 for h in handles), (
        "a 6-request pre-start burst never shared a dispatch: coalescing is not happening")
    assert srv.summary()["coalesced_max"] > 1
    serial = Executor("ila", engine="compiled", device="cpu")
    expr, _params = _tiny_program()
    for h in handles:
        envs = srv.request_envs("tiny", h.id, 1)
        np.testing.assert_array_equal(envs[0]["x"], h.envs[0]["x"],
                                      err_msg="request_envs is not reproducing the operands")
        (ref,) = serial.run_many(expr, envs)
        assert len(outs[h.id]) == 1
        np.testing.assert_array_equal(ref.numpy(), outs[h.id][0],
                                      err_msg=f"request {h.id}: coalesced differs from serial")


def test_request_rng_is_interleaving_independent():
    a = request_rng(7, 12).standard_normal(8)
    np.testing.assert_array_equal(a, request_rng(7, 12).standard_normal(8))
    assert not np.array_equal(a, request_rng(7, 13).standard_normal(8))
    assert not np.array_equal(a, request_rng(8, 12).standard_normal(8))


def test_serving_batch_ladder_restored_after_close():
    assert ila.batch_bucket(6) == 8  # pow2 default
    srv = _server()
    srv.start(warmup=0)
    try:
        assert ila.batch_bucket(6) == 6  # serving ladder: 3/4-pow2 step
    finally:
        srv.close()
    assert ila.batch_bucket(6) == 8


def test_burst_beyond_queue_depth_is_rejected():
    srv = _server(queue_depth=2, coalesce=False)
    handles = [srv.submit("tiny", batch=1) for _ in range(5)]
    rejected = [h for h in handles if h.rejected]
    accepted = [h for h in handles if not h.rejected]
    assert len(rejected) == 3 and len(accepted) == 2
    for h in rejected:
        assert h.reject_reason == REJECT_QUEUE_FULL
        assert h.done()
        with pytest.raises(RuntimeError, match="queue_full"):
            h.result(timeout=1)
    srv.start(warmup=1, warm_batch=2)
    try:
        for h in accepted:
            assert len(h.result(timeout=300)) == 1
    finally:
        srv.close(drain=True)
    assert srv.summary()["rejected"] == {REJECT_QUEUE_FULL: 3}


def test_backlog_cycle_backpressure_rejects():
    srv = _server(queue_depth=64)
    est = srv._apps["tiny"].est_cycles_per_sample
    assert est > 0, "CostModel produced no estimate for fasr_linear"
    srv.max_backlog_cycles = 1.5 * est
    h1 = srv.submit("tiny", batch=1)
    h2 = srv.submit("tiny", batch=1)
    assert not h1.rejected
    assert h2.rejected and h2.reject_reason == REJECT_BACKLOG
    srv.start(warmup=1, warm_batch=2)
    try:
        h1.result(timeout=300)
        h3 = srv.submit("tiny", batch=1)   # served work retires its cycles
        assert not h3.rejected
        h3.result(timeout=300)
    finally:
        srv.close(drain=True)


def test_close_drains_inflight_and_rejects_new():
    srv = _server(max_batch=4, queue_depth=32)
    srv.start(warmup=1, warm_batch=2)
    handles = [srv.submit("tiny", batch=1) for _ in range(7)]
    accepted = [h for h in handles if not h.rejected]
    assert accepted, "every submission was rejected before close()"
    srv.close(drain=True)
    for h in accepted:
        assert h.status == DONE, f"request {h.id} was dropped at shutdown"
        assert len(h.outputs) == 1
    assert srv.summary()["queued"] == 0
    late = srv.submit("tiny", batch=1)
    assert late.rejected and late.reject_reason == REJECT_SHUTDOWN


def test_close_without_drain_cancels_queued():
    srv = _server(coalesce=False, queue_depth=32)
    handles = [srv.submit("tiny", batch=1) for _ in range(4)]
    srv.close(drain=False)
    assert all(h.status == "cancelled" for h in handles)


# ---------------------------------------------------------------------------
# the port's own: concurrent clients, host outputs, the launcher
# ---------------------------------------------------------------------------


def test_concurrent_clients_lose_no_request():
    """More client threads than cores, a short switch interval: every
    request gets a unique id and ends served or rejected, and the server's
    counts add up."""
    srv = _server(max_batch=8, queue_depth=12)
    srv.start(warmup=1, warm_batch=2)
    handles, lock = [], threading.Lock()

    def client():
        for _ in range(4):
            h = srv.submit("tiny", batch=1)
            with lock:
                handles.append(h)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
        srv.close(drain=True)
    assert len({h.id for h in handles}) == len(handles) == 48
    assert all(h.status in (DONE, "rejected") for h in handles)
    summ = srv.summary()
    served = sum(h.status == DONE for h in handles)
    assert summ["served"] == served and sum(summ["rejected"].values()) == 48 - served


def test_outputs_come_back_as_host_arrays():
    outs = _to_host([torch.arange(6.0).reshape(2, 3), torch.ones(2, 3)])
    assert [type(o) for o in outs] == [np.ndarray, np.ndarray]
    np.testing.assert_array_equal(outs[0], np.arange(6.0).reshape(2, 3))
    mixed = _to_host([torch.ones(2), np.zeros(3)])
    assert [o.shape for o in mixed] == [(2,), (3,)]
    assert percentiles_ms([])["p50_ms"] != percentiles_ms([])["p50_ms"]   # nan
    assert percentiles_ms([0.001, 0.003])["p50_ms"] == pytest.approx(2.0)


def test_cosim_launcher_serves_and_reports(capsys):
    srv, handles = serve.main(["--cosim", "resmlp", "--device", "cpu", "--requests", "4",
                               "--batch", "2"])
    out = capsys.readouterr().out
    assert "load: 4/4 served, 0 rejected" in out
    assert "req/s" in out and "p50" in out and "p95" in out and "p99" in out
    assert all(h.status == DONE and len(h.outputs) == 2 for h in handles)
    assert all(o.shape == (1, 10) and np.isfinite(o).all() for h in handles for o in h.outputs)


def test_cosim_launcher_without_device_raises_when_cuda_absent(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--cosim", "resmlp", "--requests", "1"])
    assert "compiled" not in capsys.readouterr().out, "ran before resolving the device"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CosimServer()
