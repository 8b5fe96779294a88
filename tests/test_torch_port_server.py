"""The port's serving path (``frontends/server.py``, ``frontends/gui.py``,
``runtime/native.png_bytes``) against the JAX package's, on the CPU.

* Batch formation: one duck-typed fake pipeline drives the JAX package's
  ``BatchingEngine`` and the port's over the same submit sequences; both
  must dispatch the same batches (seeds, prompts, knobs, padding), shed the
  same requests and keep the same ``stats`` keys.
* Requests: the same payloads through both modules' ``_coerce_knobs`` /
  ``_coerce_hp`` and ``submit`` get the same accept or reject, with the
  same error text.
* Delivery: the port's dispatch blocks for the whole generation, so a
  group's tickets must be fulfilled before the next group's dispatch
  starts, and a submit must not wait for a running batch. The JAX engine,
  whose dispatch only enqueues, does neither: the same fake shows it.
* The port's engine over the port's micro pipeline: three queued requests
  make one bucket-4 batch, bitwise equal to ``generate_batch`` of the
  padded seeds and prompts. (Image parity with the JAX package is
  ``test_torch_port_batch.py``'s: the two draw seeds differently.)
* HTTP: status codes, ``/healthz``, ``/stats``, the PNG decoded with zlib
  equal to ``images_u8``, a ``save_artifacts`` tree; the web UI's page
  byte for byte the JAX package's, and one ``/execute_function``.
* ``png_bytes`` equals the bytes ``write_png`` writes.

No JAX program is built: the JAX engine only ever sees the fake pipeline.
"""
import base64
import dataclasses
import http.client
import json
import socket
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from guided_attention_tpu.config import HyperParams as JHP
from guided_attention_tpu.frontends import gui as jgui
from guided_attention_tpu.frontends import server as jserver

from guided_attention_tpu_torch.config import HyperParams as THP
from guided_attention_tpu_torch.config import RunConfig
from guided_attention_tpu_torch.frontends import gui as tgui
from guided_attention_tpu_torch.frontends import server as tserver
from guided_attention_tpu_torch.models.bundle import StableDiffusion
from guided_attention_tpu_torch.runner import GuidedAttentionPipeline
from guided_attention_tpu_torch.runtime import native

from test_torch_port_artifacts import read_png


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


P1 = "a [robot:.6,.3,.4,.55] and a [vase:0,.3,.4,.55]"
P2 = "a [robot:0,.1,.45,.5] and a [vase:.55,.4,.4,.5]"
P_ONE_GROUP = "a [robot:.6,.3,.4,.55] alone"
ENGINES = {"jax": jserver, "port": tserver}


# ---------------------------------------------------------------- fakes
class FakePipe:
    """The part of a pipeline the engine uses: ``_prepare`` (a spec at
    index 3, its group count from the meta-prompt), ``_registry_version``
    and ``dispatch_batch``, which records each call and may block."""

    def __init__(self, on_dispatch=None):
        self._registry_version = 0
        self.calls = []
        self.on_dispatch = on_dispatch

    def _prepare(self, opts):
        if not isinstance(opts.num_inference_steps, int):
            raise TypeError(f"num_inference_steps must be an int, got {opts.num_inference_steps!r}")
        spec = types.SimpleNamespace(n_groups=opts.meta_prompt.count("["), custom_group=-1, custom_losses=())
        return (None, None, None, spec)

    def dispatch_batch(self, seeds, meta_prompt=None, meta_prompts=None, **kw):
        prompts = list(meta_prompts) if meta_prompts is not None else [meta_prompt] * len(seeds)
        self.calls.append({"seeds": list(seeds), "meta_prompt": meta_prompt,
                           "meta_prompts": None if meta_prompts is None else list(meta_prompts),
                           "knobs": sorted((k, repr(v)) for k, v in kw.items())})
        if self.on_dispatch is not None:
            self.on_dispatch(len(self.calls))
        outs = [types.SimpleNamespace(seed=s, prompt=p) for s, p in zip(seeds, prompts)]
        return types.SimpleNamespace(result=lambda: outs)


# (meta_prompt, seed, knobs) in submit order; each sequence covers one rule
SEQUENCES = {
    "coalesce and pad": [(P1, 1, {}), (P1, 2, {}), (P2, 3, {})],
    "split by knob and structure": [(P1, 1, {}), (P1, 2, {"guidance_scale": 3.0}), (P_ONE_GROUP, 3, {}),
                                    (P1, 4, {})],
    "fill the largest bucket": [(P1, s, {}) for s in range(10)],
    "interleaved keys keep order": [(P1, 1, {}), (P1, 2, {"eta": 0.5}), (P2, 3, {}), (P1, 4, {"eta": 0.5}),
                                    (P1, 5, {})],
    "trim splits": [(P1, 1, {"trim_heavy_diags": True}), (P1, 2, {}), (P2, 3, {"trim_heavy_diags": True})],
    "thresholds and steps": [(P1, 1, {"thresholds": {0: 0.5}}), (P1, 2, {"thresholds": {0: 0.5}}),
                             (P1, 3, {"num_inference_steps": 2}), (P1, 4, {"thresholds": {0: 0.4}})],
    "shed past max_queue": [(P1, s, {}) for s in range(7)],
}


def _serve(module, sequence, max_queue=64):
    """Fill an unstarted engine, then let its batcher drain the queue."""
    pipe = FakePipe()
    eng = module.BatchingEngine(pipe, max_wait_ms=0.0, buckets=(1, 2, 4, 8), max_queue=max_queue,
                                _start_thread=False)
    tickets, shed = [], 0
    for prompt, seed, knobs in sequence:
        try:
            tickets.append(eng.submit(prompt, seed=seed, **dict(knobs)))
        except module.OverloadedError:
            shed += 1
    eng._thread.start()
    eng.close(timeout=30)
    assert not eng._thread.is_alive()
    outs = [t.result(timeout=1) for t in tickets]
    assert [o.seed for o in outs] == [t.seed for t in tickets]  # padded outputs dropped, order kept
    return pipe.calls, eng.snapshot(), shed


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_batch_formation_equals_the_jax_engine(name):
    max_queue = 5 if name.startswith("shed") else 64
    j_calls, j_snap, j_shed = _serve(jserver, SEQUENCES[name], max_queue)
    t_calls, t_snap, t_shed = _serve(tserver, SEQUENCES[name], max_queue)
    assert t_calls == j_calls
    assert t_shed == j_shed and t_snap["shed"] == j_snap["shed"] == j_shed
    assert set(t_snap) == set(j_snap)
    for k in ("requests", "errors", "batches", "samples", "padded_samples", "batch_sizes", "queued", "preparing"):
        assert t_snap[k] == j_snap[k], k
    if name == "coalesce and pad":
        assert t_calls[0]["seeds"] == [1, 2, 3, 3] and t_snap["batch_sizes"] == {4: 1}
    if name.startswith("shed"):
        assert t_shed == 2 and t_snap["requests"] == 5


# ------------------------------------------------------------- requests
KNOB_PAYLOADS = [
    {"thresholds": {"0": 0.5, "3": "0.2"}, "scale_range": [1, 0.5]},
    {"hp": {"strict": True, "recurse_steps": 2.0, "shrink_factor": 0.1}},
    {"hp": {"thresholds": {"0": 1.0}}},
    {"hp": {"optimize_deep_latent": True}},
    {"hp": [1, 2]},
    {"hp": {"strict": 1}},
    {"hp": {"recurse_steps": True}},
    {"hp": {"recurse_steps": 1.5}},
    {"hp": {"recurse_steps": 0}},
    {"hp": {"bb_center_weight": "big"}},
    {"hp": {"shrink_factor": 1.0}},
    {"thresholds": {"x": 1.0}},
    {"scale_range": ["a", 1]},
]


def _outcome(fn):
    try:
        out = fn()
    except Exception as e:  # the outcome is compared across the packages
        return ("reject", type(e).__name__, str(e))
    if isinstance(out, dict) and out.get("hp") is not None:
        out = dict(out, hp=dataclasses.asdict(out["hp"]))
    return ("accept", repr(out))


@pytest.mark.parametrize("payload", KNOB_PAYLOADS, ids=range(len(KNOB_PAYLOADS)))
def test_coerce_knobs_accepts_and_rejects_as_the_jax_server(payload):
    j = _outcome(lambda: jserver._coerce_knobs(json.loads(json.dumps(payload))))
    t = _outcome(lambda: tserver._coerce_knobs(json.loads(json.dumps(payload))))
    assert t == j
    assert tserver._KNOB_FIELDS == jserver._KNOB_FIELDS
    assert tserver._HP_HTTP_FIELDS == jserver._HP_HTTP_FIELDS


SUBMITS = [
    ("", {}),
    ("   ", {}),
    (P1, {"not_a_knob": True}),
    (P1, {"num_inference_steps": "nope"}),
    (P1, {"hp": {"recurse_steps": 1}}),
    (P1, {"hp": "HP"}),  # replaced by each package's HyperParams below
    (P1, {"trim_heavy_diags": True, "guidance_scale": 2.0}),
]


@pytest.mark.parametrize("i", range(len(SUBMITS)))
def test_submit_accepts_and_rejects_as_the_jax_engine(i):
    prompt, knobs = SUBMITS[i]
    outcomes = []
    for module, hp in ((jserver, JHP(recurse_steps=1)), (tserver, THP(recurse_steps=1))):
        kw = {k: (hp if v == "HP" else v) for k, v in knobs.items()}
        eng = module.BatchingEngine(FakePipe(), _start_thread=False)
        outcome = _outcome(lambda: eng.submit(prompt, seed=1, **kw).seed)
        outcomes.append((outcome, eng.stats["requests"], eng.snapshot()["preparing"]))
        eng.close()
    assert outcomes[1] == outcomes[0]


def test_warmup_serves_every_bucket_with_one_prompt_and_two():
    pipe = FakePipe()
    eng = tserver.BatchingEngine(pipe, max_wait_ms=0.0, buckets=(1, 2, 4))
    try:
        tserver.warmup(eng, num_inference_steps=3)
    finally:
        eng.close(timeout=30)
    shapes = [(len(c["seeds"]), c["meta_prompt"] is None) for c in pipe.calls]
    assert shapes == [(1, False), (2, False), (2, True), (4, False), (4, True)]
    assert all(("num_inference_steps", "3") in c["knobs"] for c in pipe.calls)


def test_engine_refuses_a_mesh():
    """A mesh is served (the two-rank launch of
    ``tests/test_torch_port_parallel.py``); refused are buckets the data
    axis does not divide (the JAX engine's check), an engine off rank 0,
    and a mesh larger than the process group."""
    from guided_attention_tpu_torch.parallel import multihost
    from guided_attention_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match=r"buckets \[1, 3\] not divisible by the mesh data axis \(2\)"):
        tserver.BatchingEngine(FakePipe(), buckets=(1, 2, 3, 4), mesh=Mesh(("data",), (2,)), _start_thread=False)
    eng = tserver.BatchingEngine(FakePipe(), buckets=(2, 4), mesh=Mesh(("data", "tensor"), (2, 1)),
                                 _start_thread=False)
    assert eng.mesh.shape == {"data": 2, "tensor": 1}
    with pytest.raises(RuntimeError, match="follow"):
        tserver.follow(FakePipe(), Mesh(("data",), (1,)))  # rank 0 serves
    assert multihost.process_count() == 1
    with pytest.raises(ValueError, match="needs 2 processes; the process group has 1"):
        tserver.main(["--mesh_shape", '{"data": 2}', "--device", "cpu", "--model", "micro"])


# ------------------------------------------------------------- delivery
@pytest.mark.parametrize("pkg, fulfilled_first", [("port", True), ("jax", False)])
def test_a_group_is_delivered_before_the_next_dispatch(pkg, fulfilled_first):
    """Two groups, each dispatch blocking as the port's does for a whole
    generation: when the second dispatch starts, the first group's ticket
    must already be fulfilled (the JAX engine delivers it only after)."""
    seen = {}
    tickets = []

    def on_dispatch(n):
        if n == 2:
            seen["first_done_at_second_dispatch"] = tickets[0]._event.is_set()
        time.sleep(0.2)

    eng = ENGINES[pkg].BatchingEngine(FakePipe(on_dispatch), max_wait_ms=0.0, buckets=(1, 2), _start_thread=False)
    tickets.append(eng.submit(P1, seed=1))
    tickets.append(eng.submit(P1, seed=2, guidance_scale=3.0))
    eng._thread.start()
    for t in tickets:
        t.result(timeout=30)
    eng.close(timeout=30)
    assert seen["first_done_at_second_dispatch"] is fulfilled_first


@pytest.mark.parametrize("pkg, submit_waits", [("port", False), ("jax", True)])
def test_a_submit_does_not_wait_for_a_running_batch(pkg, submit_waits):
    """While a dispatch runs, a new request is prepared and queued at once,
    and coalesces into the next batch."""
    entered, release = threading.Event(), threading.Event()

    def on_dispatch(n):
        if n == 1:
            entered.set()
            release.wait(20)

    pipe = FakePipe(on_dispatch)
    eng = ENGINES[pkg].BatchingEngine(pipe, max_wait_ms=200.0, buckets=(1, 2, 4))
    try:
        first = eng.submit(P1, seed=1)
        assert entered.wait(20)
        late = []
        submitter = threading.Thread(target=lambda: late.extend(eng.submit(P1, seed=s) for s in (2, 3)))
        submitter.start()
        submitter.join(2.0)
        assert submitter.is_alive() is submit_waits
        release.set()
        submitter.join(20)
        assert not submitter.is_alive()
        first.result(timeout=20)
        for t in late:
            t.result(timeout=20)
    finally:
        release.set()
        eng.close(timeout=30)
    if not submit_waits:
        assert [c["seeds"] for c in pipe.calls] == [[1], [2, 3]]


@pytest.mark.parametrize("pkg, first_group_batches", [("port", (1.0, 1.5)), ("jax", (1.5, 3.0))])
def test_perf_server_burst_shows_when_the_first_group_is_delivered(pkg, first_group_batches):
    """``perf_server.run_load`` with 8 clients of one request each, all
    queued before the batcher starts, buckets up to 4, each dispatch
    blocking as the port's does: two groups of 4 wait at once. The port
    delivers the first with its own batch (about one batch time); the JAX
    loop, after the second group's dispatch (about two). This is what
    ``chip_smoke.py`` phase 10 (d) reads on the card."""
    from guided_attention_tpu_torch import perf_server

    batch_s = 0.3
    eng = ENGINES[pkg].BatchingEngine(FakePipe(lambda n: time.sleep(batch_s)), max_wait_ms=perf_server.MAX_WAIT_MS,
                                      buckets=(1, 2, 4), _start_thread=False)
    rows = []
    load = threading.Thread(target=lambda: rows.append(perf_server.run_load(eng, 8, 8, steps=2)))
    load.start()
    try:
        deadline = time.monotonic() + 20
        while eng.snapshot()["queued"] < 8 and time.monotonic() < deadline:
            time.sleep(0.01)
        eng._thread.start()
        load.join(30)
    finally:
        eng.close(timeout=30)
    (row,) = rows
    assert row["batch_sizes"] == {4: 2} and row["padded_samples"] == 0
    lo, hi = first_group_batches
    assert lo * batch_s <= row["latency_s"]["min"] < hi * batch_s
    text = perf_server.report(row, "cpu")
    assert "smoke reading" in text and "p95" not in text  # 8 latencies: the p95 is the maximum
    assert "sustained" in perf_server.report(dict(row, requests=24), "cpu")


def test_a_failed_batch_fails_its_group_only():
    def on_dispatch(n):
        if n == 1:
            raise RuntimeError("injected device failure")

    eng = tserver.BatchingEngine(FakePipe(on_dispatch), max_wait_ms=0.0)
    try:
        with pytest.raises(RuntimeError, match="injected"):
            eng.submit(P1, seed=1).result(timeout=20)
        assert eng.submit(P1, seed=2).result(timeout=20).seed == 2
    finally:
        eng.close(timeout=30)
    assert eng.stats["errors"] == 1 and eng.stats["batches"] == 1


def test_prepare_cache_under_concurrent_submits(monkeypatch):
    """Handler threads prepare while the batcher reads the runner's caches:
    many threads filling and evicting the prepare cache at once must each
    get their own entry and leave the cache within its bound."""
    import sys

    from guided_attention_tpu_torch.runner import PrepareOptions

    pipe = GuidedAttentionPipeline(None)
    monkeypatch.setattr(pipe, "_prepare_uncached", lambda opts: ("prepared", opts.seed_tag))
    errors, mismatches = [], []

    def worker(w):
        try:
            for i in range(100):
                tag = (w * 7 + i) % 97  # more keys than the cache holds: constant eviction
                opts = PrepareOptions(meta_prompt=f"p{tag}", guidance_scale=float(tag))
                object.__setattr__(opts, "seed_tag", tag)
                if pipe._prepare(opts) != ("prepared", tag):
                    mismatches.append((w, tag))
        except Exception as e:  # collected and asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(w,)) for w in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not mismatches
    assert len(pipe._prepare_cache) <= 64


# ------------------------------------------------ the port's micro model
KNOBS = dict(num_inference_steps=1, attention_res=4, hp=THP(recurse_steps=1))


@pytest.fixture(scope="module")
def pipe():
    return GuidedAttentionPipeline(StableDiffusion.create("micro", torch.float32, device="cpu"))


def test_engine_batches_equal_generate_batch(pipe):
    eng = tserver.BatchingEngine(pipe, max_wait_ms=0.0, buckets=(1, 2, 4), _start_thread=False)
    tickets = [eng.submit(P1, seed=1, **KNOBS), eng.submit(P1, seed=2, **KNOBS), eng.submit(P2, seed=3, **KNOBS)]
    eng._thread.start()
    outs = [t.result(timeout=120) for t in tickets]
    eng.close(timeout=60)
    assert eng.stats["batch_sizes"] == {4: 1} and eng.stats["padded_samples"] == 1
    want = pipe.generate_batch([1, 2, 3, 3], meta_prompts=[P1, P1, P2, P2], capture_diagnostics=False, **KNOBS)
    for o, w in zip(outs, want):
        assert np.array_equal(o.images_u8, w.images_u8)
        assert np.array_equal(o.latents, w.latents)
    assert not np.array_equal(outs[2].images_u8, outs[0].images_u8)


def _post(port, path, body, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=body if isinstance(body, bytes) else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.read(), dict(r.getheaders())
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read(), dict(r.getheaders())
    finally:
        conn.close()


def test_http_round_trip(pipe, tmp_path):
    eng = tserver.BatchingEngine(pipe, max_wait_ms=0.0, buckets=(1, 2, 4))
    server = tserver.make_server(eng, host="127.0.0.1", port=0, artifact_dir=tmp_path)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        status, body, _ = _get(port, "/healthz")
        assert status == 200 and json.loads(body) == {"ok": True, "device": "cpu", "device_name": "cpu",
                                                      "model": "micro"}
        req = dict(meta_prompt=P1, seed=11, num_inference_steps=1, attention_res=4, hp={"recurse_steps": 1})
        status, body, headers = _post(port, "/generate", req)
        assert status == 200 and headers["Cache-Control"] == "no-store"
        out = json.loads(body)
        want = pipe.generate_batch([11], meta_prompt=P1, capture_diagnostics=False, **KNOBS)[0]
        png = base64.b64decode(out["image_png_b64"])
        assert png == native.png_bytes(want.images_u8[0])
        png_path = tmp_path / "served.png"
        png_path.write_bytes(png)
        assert np.array_equal(read_png(png_path), want.images_u8[0])
        assert (out["seed"], out["width"], out["height"], out["prompt"]) == (11, 128, 128, want.prompt)

        for bad in ({"meta_prompt": ""}, dict(req, hp={"recurse_steps": 0}), dict(req, not_a_knob=1),
                    dict(req, num_inference_steps="x"), [1, 2]):
            status, body, _ = _post(port, "/generate", bad)
            assert status == 400, (bad, body)
        assert _post(port, "/generate", b"{not json")[0] == 400
        assert _post(port, "/nowhere", {})[0] == 404 and _get(port, "/nowhere")[0] == 404

        status, body, _ = _post(port, "/generate", dict(req, seed=12, save_artifacts=True))
        assert status == 200
        art = json.loads(body)
        assert "artifacts_error" not in art, art
        image = Path(art["artifacts_path"])
        assert image.exists() and image.relative_to(tmp_path).parts[0] == "req000000"
        assert np.array_equal(read_png(image), read_png_b64(art["image_png_b64"], tmp_path))
        assert list(image.parent.glob("12*.txt")) and list((image.parent / "12").glob("_attnmap_*"))

        stats = json.loads(_get(port, "/stats")[1])
        assert stats["requests"] == 2 and stats["batches"] == 2 and stats["batch_sizes"] == {"1": 2}
        assert stats["latency_s"]["p95"] >= stats["latency_s"]["p50"] > 0
    finally:
        server.shutdown()
        server.server_close()
        eng.close(timeout=60)


def read_png_b64(b64: str, tmp_path) -> np.ndarray:
    p = tmp_path / "b64.png"
    p.write_bytes(base64.b64decode(b64))
    return read_png(p)


def test_http_error_codes_and_artifact_knobs(tmp_path, monkeypatch):
    """Codes that need no generation: a submit fault is a 503 (shut down,
    overloaded, device fault) or a 500 (anything else), a timeout a 504;
    save_artifacts forces the diagnostics the tree reads, as the JAX
    server does."""
    eng = tserver.BatchingEngine(FakePipe(), _start_thread=False)
    captured = {}

    class Late:
        seed, meta_prompt, knobs = 1, P1, {}

        def result(self, timeout=None):
            raise TimeoutError("no batcher in this test")

    def fake_submit(meta_prompt, seed=None, **knobs):
        captured.clear()
        captured.update(knobs)
        return Late()

    monkeypatch.setattr(eng, "submit", fake_submit)
    server = tserver.make_server(eng, port=0, artifact_dir=tmp_path)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        assert _post(port, "/generate", dict(meta_prompt=P1, save_artifacts=True, capture_diagnostics=False,
                                             diagnostic_level=1))[0] == 504
        assert captured["capture_diagnostics"] is True and captured["capture_eval_latents"] is True
        assert "trim_heavy_diags" not in captured
        assert _post(port, "/generate", dict(meta_prompt=P1, save_artifacts=True))[0] == 504
        assert captured["trim_heavy_diags"] is True and captured["capture_diagnostics"] is True
        for exc, code in ((tserver.OverloadedError("queue full"), 503), (RuntimeError("engine is shut down"), 503),
                          (KeyError("x"), 500)):
            def raising(meta_prompt, seed=None, exc=exc, **knobs):
                raise exc
            monkeypatch.setattr(eng, "submit", raising)
            assert _post(port, "/generate", dict(meta_prompt=P1))[0] == code
    finally:
        server.shutdown()
        server.server_close()
    no_dir = tserver.make_server(eng, port=0)
    threading.Thread(target=no_dir.serve_forever, daemon=True).start()
    try:
        status, body, _ = _post(no_dir.server_address[1], "/generate", dict(meta_prompt=P1, save_artifacts=True))
        assert status == 400 and "artifact_dir" in json.loads(body)["error"]
    finally:
        no_dir.shutdown()
        no_dir.server_close()


# ----------------------------------------------------------------- GUI
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _once(config, pipe, engine, request):
    """Serve one request through ``gui.run_server(once=True)``; the client
    retries until the server listens."""
    port = _free_port()
    server = threading.Thread(target=tgui.run_server, args=(config, pipe),
                              kwargs=dict(port=port, once=True, engine=engine), daemon=True)
    server.start()
    deadline = time.monotonic() + 30
    while True:
        try:
            out = request(port)
            break
        except ConnectionRefusedError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)
    server.join(60)
    assert not server.is_alive()
    return out


def test_gui_config_knobs_equal_the_jax_gui():
    from guided_attention_tpu.config import RunConfig as JRunConfig

    for kw in ({}, dict(diagnostic_level=1, save_all_maps=True, n_inference_steps=7, eta=0.5),
               dict(save_individual_ca_maps=True, scale_range=(1.0, 0.2))):
        t = tgui._config_knobs(RunConfig(**kw), THP())
        j = jgui._config_knobs(JRunConfig(**kw), JHP())
        assert t.keys() == j.keys()
        assert {k: v for k, v in t.items() if k != "hp"} == {k: v for k, v in j.items() if k != "hp"}


def test_gui_serves_the_page_and_one_generation(pipe, tmp_path):
    config = RunConfig(model="micro", device="cpu", output_path=tmp_path, n_inference_steps=1, attention_res=4)
    eng = tserver.BatchingEngine(pipe, max_wait_ms=0.0)
    try:
        status, page, headers = _once(config, pipe, eng, lambda port: _get(port, "/"))
        assert status == 200 and headers["Cache-Control"] == "no-store"
        assert page == (Path(jgui.WEB_DIR) / "ui.html").read_bytes()
        assert tgui.WEB_DIR.resolve() != Path(jgui.WEB_DIR).resolve()  # the port's own copy

        status, body, _ = _once(config, pipe, eng, lambda port: _post(port, "/execute_function", {"variable1": P1}))
        assert status == 200, body
        result = Path(json.loads(body)["result"])
        img = read_png(tmp_path / "static" / "output.png")
        assert result.exists() and img.shape == (128, 128, 3) and np.array_equal(img, read_png(result))
        status, body, _ = _once(config, pipe, eng, lambda port: _post(port, "/execute_function", b"[1]"))
        assert status == 400
    finally:
        eng.close(timeout=60)


# ------------------------------------------------------------ png_bytes
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_png_bytes_equal_write_png(dtype, tmp_path):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    if dtype == "float32":
        img = img.astype(np.float32) / 255.0
    path = tmp_path / "x.png"
    assert native.write_png(img, path)
    data = native.png_bytes(img)
    assert data == path.read_bytes()
    assert np.array_equal(read_png(path), native.to_u8(img))
