"""The serving front end: a micro-batching HTTP inference server.

Counterpart of the JAX package's ``frontends/server.py``. Concurrent
requests are prepared on arrival (prompt grammar, spec, CLIP embedding
through the runner's prepare cache; a malformed request fails alone), kept
apart by compatibility (every knob but the prompt, and the spec's group
structure: ``guidance.spec.stack_specs``), rounded up to a batch-size
bucket by repeating the last request, and run as one
``GuidedAttentionPipeline.dispatch_batch``; padded outputs are dropped. The
request fields, limits, error texts, HTTP routes and codes, load shedding
and ``/stats`` are the JAX server's.

What differs from the JAX engine, and why. The JAX server relies on JAX's
asynchronous dispatch; the port's ``dispatch_batch`` returns only when the
host has issued the batch's last launch (its loop reads a host bool at every
guidance eval), and the card trails the host by little. So:

- **Delivery right after the batch.** The JAX batcher dispatches group i+1
  before it delivers group i (guided_attention_tpu/frontends/server.py:409-440,
  ``_deliver_outputs`` at :437), which here would make group i's clients
  wait for group i+1's whole generation. ``_loop`` runs each batch, copies
  it to the host and fulfils its tickets in one step, before it gathers the
  next group; requests that arrive meanwhile queue and coalesce into the
  next group.
- **No lock across the dispatch.** The JAX engine holds ``_pipe_lock`` across
  a dispatch (:427-428) and around every submit-time prepare (:254): there a
  dispatch only enqueues, here it is the whole generation (seconds). The
  runner guards its prepare and stack caches with a lock of its own, held
  around the dictionary reads and writes alone (``runner._cache_lock``), so
  a prepare (a CLIP forward on a cache miss) runs beside a generation
  instead of waiting for it.
- **No busy-aware deadline.** ``_inflight_deadline`` (:346-361) extends group
  formation while a batch is on the device. Here no batch is in flight while
  the batcher gathers, so a group waits ``max_wait_ms`` as the JAX engine's
  does with nothing in flight.
- PNGs come from the port's native writer (``runtime/native.png_bytes``,
  zlib level 1), not PIL (:475-483); ``/healthz`` reports the torch device
  and the card's name (:569 reads ``jax.devices()``); the x0-decode
  compile guard (:534-550) has no counterpart, since nothing compiles per
  shape.
- **A mesh is several processes in lockstep.** The JAX server hands its
  mesh to one jitted program over every device of its process (:395-396).
  Here one process drives one GPU (``parallel/``): rank 0 runs the engine
  (``BatchingEngine(mesh=)``) and the HTTP server, and every other rank
  runs ``follow(pipe, mesh)``. For each group rank 0 broadcasts over the
  world group what it is about to dispatch (the padded seeds and prompts,
  the knobs), and every rank makes the same ``dispatch_batch(...,
  mesh=)``. When the engine is idle it broadcasts a tick within the
  group's timeout, and when it closes a stop, which ends the followers. A
  rank whose part of a batch fails makes ``dispatch_batch`` raise on every
  rank (``parallel.batch.BatchFailed``): the group's requests get an error
  and the ranks stay in step; a rank that dies makes the others' next
  collective time out (``multihost.TIMEOUT_S``), so requests fail rather
  than hang. Every bucket must divide by the mesh's data axis (:183-191).

HTTP protocol (stdlib ThreadingHTTPServer; handler threads block on their
ticket, the batcher thread runs every batch):
  POST /generate {"meta_prompt": "...", "seed"?: int, <generation knobs>,
                  "hp"?: {<curated HyperParams>},
                  "save_artifacts"?: bool, "annotate"?: bool}
       -> {"seed", "prompt", "width", "height", "image_png_b64",
           "artifacts_path"?}
       400 invalid request | 503 queue full (load shed) | 504 timeout
  GET  /healthz  -> {"ok", "device", "device_name", "model"}, and "mesh"
                    ({"data": ..., "tensor": ...}) when serving over one
  GET  /stats    -> batching counters (requests, batches, sizes, padding,
                    shed) + e2e latency percentiles (p50/p95/max)

Run:  python -m guided_attention_tpu_torch.frontends.server --model sd15 --port 8100 [--warmup]
Over N GPUs, one process each (rank 0 serves):
      python -m torch.distributed.run --standalone --nproc_per_node N \
          -m guided_attention_tpu_torch.frontends.server --mesh_shape '{"data": N}' --buckets N,2N
"""
from __future__ import annotations

import base64
import dataclasses
import itertools
import json
import random
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from guided_attention_tpu_torch.config import HyperParams
from guided_attention_tpu_torch.parallel import multihost
from guided_attention_tpu_torch.parallel.batch import BatchFailed
from guided_attention_tpu_torch.runner import GuidedAttentionPipeline, PipelineOutput, PrepareOptions

# Request knobs the server accepts: every PrepareOptions field except the
# prompt carriers and host objects. "hp" is accepted as a nested object
# restricted to _HP_HTTP_FIELDS (coerced by _coerce_hp).
_KNOB_FIELDS = tuple(
    f.name for f in dataclasses.fields(PrepareOptions) if f.name not in ("meta_prompt", "prompt", "annotations")
)

# The HyperParams surface over HTTP (the reference's override-grid knobs,
# utils/shared_state.py:21-36). Left out: meta_prompt (the top-level field
# carries the prompt), thresholds (the top-level "thresholds" knob), and
# optimize_deep_latent (API and CLI only). (name, type, (lo, hi)); bools
# reject 0 and 1 so that "strict": "true" fails loudly.
_HP_HTTP_FIELDS: Dict[str, Tuple[type, Tuple[float, float]]] = {
    "strict": (bool, (0, 1)),
    "use_optimizer": (bool, (0, 1)),
    "recurse_steps": (int, (1, 100)),
    "recurse_until": (int, (-1, 10_000)),
    "paint_with_words_stop": (int, (0, 10_000)),
    "inside_loss_scale": (float, (0.0, 1e6)),
    "outside_loss_scale": (float, (0.0, 1e6)),
    "shrink_factor": (float, (0.0, 0.99)),
    "bb_center_weight": (float, (0.0, 1e6)),
    "paint_with_words_weight": (float, (0.0, 1e6)),
    "keyword_max_loss_scale": (float, (0.0, 1e6)),
}


class RequestError(ValueError):
    """A per-request validation error (HTTP 400)."""


class OverloadedError(RuntimeError):
    """The queue depth limit was hit: load is shed, not queued (HTTP 503),
    which keeps tail latency near max_queue x batch time."""


def _coerce_hp(obj: Any) -> HyperParams:
    """JSON object -> validated HyperParams (unknown, ill-typed or
    out-of-range fields are per-request errors, HTTP 400)."""
    if not isinstance(obj, dict):
        raise RequestError(f"hp must be a JSON object, got {type(obj).__name__}")
    unknown = set(obj) - set(_HP_HTTP_FIELDS)
    if unknown:
        raise RequestError(f"unknown hp field(s): {sorted(unknown)}; allowed: {sorted(_HP_HTTP_FIELDS)}")
    out: Dict[str, Any] = {}
    for name, value in obj.items():
        typ, (lo, hi) = _HP_HTTP_FIELDS[name]
        if typ is bool:
            if not isinstance(value, bool):
                raise RequestError(f"hp.{name} must be a JSON boolean, got {value!r}")
            out[name] = value
            continue
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise RequestError(f"hp.{name} must be a number, got {value!r}")
        if typ is int and not float(value).is_integer():
            raise RequestError(f"hp.{name} must be an integer, got {value!r}")
        value = typ(value)
        if not (lo <= value <= hi):
            raise RequestError(f"hp.{name} must be in [{lo}, {hi}], got {value}")
        out[name] = value
    return HyperParams(**out)


def _coerce_knobs(payload: Dict[str, Any]) -> Dict[str, Any]:
    """JSON -> PrepareOptions field types (thresholds keys, tuples, hp)."""
    knobs = dict(payload)
    if isinstance(knobs.get("thresholds"), dict):
        knobs["thresholds"] = {int(k): float(v) for k, v in knobs["thresholds"].items()}
    if isinstance(knobs.get("scale_range"), list):
        knobs["scale_range"] = tuple(float(v) for v in knobs["scale_range"])
    if knobs.get("hp") is not None:
        knobs["hp"] = _coerce_hp(knobs["hp"])
    return knobs


@dataclasses.dataclass
class ServeTicket:
    """Future for one submitted request; fulfilled by the batcher thread."""

    meta_prompt: str
    seed: int
    knobs: Dict[str, Any]
    group_key: Any
    _event: threading.Event = dataclasses.field(default_factory=threading.Event)
    _output: Optional[PipelineOutput] = None
    _error: Optional[BaseException] = None
    submitted_at: float = dataclasses.field(default_factory=time.monotonic)

    def result(self, timeout: Optional[float] = None) -> PipelineOutput:
        if not self._event.wait(timeout):
            raise TimeoutError("generation did not complete in time")
        if self._error is not None:
            raise self._error
        if self._output is None:
            raise RuntimeError("ticket fulfilled without an output")
        return self._output


def _check_buckets(buckets: Tuple[int, ...], mesh) -> Tuple[int, ...]:
    """The batch sizes, sorted; over a mesh each must divide by its data
    axis, since the batch axis splits over "data"."""
    out = tuple(sorted(set(int(b) for b in buckets)))
    if not out or out[0] < 1:
        raise ValueError(f"invalid batch buckets: {buckets}")
    data = 1 if mesh is None else mesh.shape.get("data", 1)
    bad = [b for b in out if b % data]
    if bad:
        raise ValueError(f"buckets {bad} not divisible by the mesh data axis ({data})")
    return out


def _run_lockstep(pipe: GuidedAttentionPipeline, msg: Dict[str, Any], mesh):
    """The ``dispatch_batch`` of one lockstep message (every rank's call)."""
    prompts, kwargs = msg["prompts"], dict(msg["knobs"])
    if mesh is not None:  # the JAX engine's keywords otherwise
        kwargs["mesh"] = mesh
    if all(p == prompts[0] for p in prompts):
        return pipe.dispatch_batch(msg["seeds"], meta_prompt=prompts[0], **kwargs)
    return pipe.dispatch_batch(msg["seeds"], meta_prompts=prompts, **kwargs)


def follow(pipe: GuidedAttentionPipeline, mesh) -> int:
    """A rank other than 0 of a served mesh: run every batch rank 0's
    engine dispatches, in lockstep, until its stop message. A batch that
    fails on any rank fails on all of them (``BatchFailed``): rank 0
    answers its requests with the error and this rank waits for the next.
    Returns the number of batches run."""
    if multihost.is_primary():
        raise RuntimeError("follow() runs on the ranks other than 0; rank 0 runs the BatchingEngine")
    done = 0
    while True:
        msg = multihost.broadcast_object(None)
        if msg["op"] == "stop":
            return done
        if msg["op"] != "batch":  # an idle tick
            continue
        try:
            _run_lockstep(pipe, msg, mesh).result()
        except BatchFailed as e:
            print(f"rank {multihost.process_index()}: batch failed: {e}", file=sys.stderr, flush=True)
        done += 1


class BatchingEngine:
    """Coalesces concurrent generation requests into batches.

    Thread model: any number of producer threads call ``submit``, which
    prepares the request in the caller's thread; one batcher thread runs
    every batch and delivers it before it gathers the next group. With a
    ``mesh`` (``parallel.make_mesh``) the engine runs on rank 0 and every
    other rank runs ``follow``: the batcher thread broadcasts each group
    before its dispatch, a tick when idle and a stop when the engine closes.
    """

    def __init__(
        self,
        pipe: GuidedAttentionPipeline,
        max_wait_ms: float = 100.0,
        buckets: Tuple[int, ...] = (1, 2, 4, 8),
        mesh=None,
        max_queue: int = 64,
        _start_thread: bool = True,
    ):
        self.pipe = pipe
        self.max_wait_s = max_wait_ms / 1000.0
        self.buckets = _check_buckets(buckets, mesh)
        self.mesh = mesh
        if mesh is not None and not multihost.is_primary():
            raise RuntimeError("the engine of a mesh runs on rank 0; the other ranks run follow()")
        # a follower waits for the next message in a collective: tick well
        # within the group's timeout while no request comes
        self._idle_tick_s = multihost.TIMEOUT_S / 4
        self.max_batch = self.buckets[-1]
        self.max_queue = int(max_queue)

        self._queue: deque[ServeTicket] = deque()
        self._cv = threading.Condition()
        self._in_prepare = 0  # admitted, still in submit-time prepare
        self._stop = False
        self._latencies: deque[float] = deque(maxlen=256)  # completed e2e, s
        self.stats: Dict[str, Any] = {
            "requests": 0,
            "errors": 0,
            "shed": 0,  # rejected by the queue depth limit (503s)
            "batches": 0,
            "samples": 0,
            "padded_samples": 0,
            "batch_sizes": {},  # dispatched (bucketed) size -> count
            "last_batch_s": None,
        }
        self._thread = threading.Thread(target=self._loop, name="ga-batcher", daemon=True)
        if _start_thread:  # tests fill the queue deterministically first
            self._thread.start()

    # ------------------------------------------------------------- submit
    def submit(self, meta_prompt: str, seed: Optional[int] = None, **knobs) -> ServeTicket:
        """Validate, prepare (spec + CLIP embedding, cached), and enqueue."""
        t_submit = time.monotonic()  # the prepare is part of the client's latency
        # a dispatch_batch keyword, not a PrepareOptions field; it splits
        # batches all the same, since a batch is trimmed whole
        trim = bool(knobs.pop("trim_heavy_diags", False))
        unknown = set(knobs) - set(_KNOB_FIELDS)
        if unknown:
            raise RequestError(f"unknown field(s): {sorted(unknown)}")
        if knobs.get("hp") is not None and not isinstance(knobs["hp"], HyperParams):
            # HTTP clients send a JSON object (coerced by _coerce_hp); API
            # callers pass a HyperParams
            raise RequestError(f"hp must be a HyperParams, got {type(knobs['hp']).__name__}")
        if not isinstance(meta_prompt, str) or not meta_prompt.strip():
            raise RequestError("meta_prompt must be a non-empty string")
        if seed is None:
            seed = random.randrange(4294967294)  # reference gui.py:29
        knobs.setdefault("capture_diagnostics", False)  # serving: the image path

        # admission before the prepare: an overloaded server answers 503 at
        # once, and requests still preparing count as load
        with self._cv:
            if self._stop:
                raise RuntimeError("engine is shut down")
            if len(self._queue) + self._in_prepare >= self.max_queue:
                self.stats["shed"] += 1
                raise OverloadedError(f"queue full ({self.max_queue} requests waiting) — retry later")
            self._in_prepare += 1

        try:
            opts = PrepareOptions(meta_prompt=meta_prompt, **knobs)
            try:
                prepared = self.pipe._prepare(opts)
            except RequestError:
                raise
            except (ValueError, TypeError, KeyError) as e:
                # parse, spec, tokenizer and knob errors: the request is bad
                # (400). Anything else (a device fault, out of memory in the
                # CLIP forward) propagates as a server fault (5xx).
                raise RequestError(f"invalid request: {e}") from e
            spec = prepared[3]
            # batchable iff every non-prompt knob matches (cache_key derives
            # from PrepareOptions' field list, so no knob is left out) and
            # the specs share their static structure (stack_specs)
            key_opts = dataclasses.replace(opts, meta_prompt="")
            group_key = (
                key_opts.cache_key(self.pipe._registry_version),
                spec.n_groups,
                spec.custom_group,
                spec.custom_losses,
                trim,
            )
            if trim:
                knobs["trim_heavy_diags"] = True  # -> dispatch_batch keyword
            ticket = ServeTicket(meta_prompt=meta_prompt, seed=int(seed), knobs=knobs, group_key=group_key,
                                 submitted_at=t_submit)
        except BaseException:
            with self._cv:
                self._in_prepare -= 1
            raise

        with self._cv:
            self._in_prepare -= 1  # the admitted slot becomes the queue slot
            if self._stop:
                raise RuntimeError("engine is shut down")
            self._queue.append(ticket)
            self.stats["requests"] += 1
            self._cv.notify_all()
        return ticket

    def snapshot(self) -> Dict[str, Any]:
        """Stats + latency percentiles of the last 256 completed requests."""
        with self._cv:
            snap = dict(self.stats, queued=len(self._queue), preparing=self._in_prepare)
            snap["batch_sizes"] = dict(self.stats["batch_sizes"])
            lats = sorted(self._latencies)
        if lats:
            snap["latency_s"] = {
                "p50": round(lats[len(lats) // 2], 3),
                "p95": round(lats[min(len(lats) - 1, int(len(lats) * 0.95))], 3),
                "max": round(lats[-1], 3),
            }
        return snap

    def close(self, timeout: float = 600.0) -> None:
        """Drain the queue, deliver every batch, stop the thread."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread.ident is None:  # never started (_start_thread=False)
            return
        self._thread.join(timeout)
        if self._thread.is_alive():  # a batcher left running would race the next engine on the pipeline
            raise RuntimeError(f"batcher did not drain within {timeout}s; in-flight requests are still running")

    # ------------------------------------------------------------ batcher
    def _pop_first(self, block: bool, timeout: Optional[float] = None) -> Optional[ServeTicket]:
        """The oldest request; None when stopped with the queue drained, when
        not blocking, or after ``timeout`` seconds without one."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while not self._queue:
                if self._stop or not block or (deadline is not None and time.monotonic() >= deadline):
                    return None
                self._cv.wait(timeout=0.1)
            return self._queue.popleft()

    def _gather(self, first: ServeTicket) -> List[ServeTicket]:
        """Collect same-key requests for up to max_wait_s, returning early at
        a full bucket. Other-key requests stay queued in order."""
        group = [first]
        deadline = time.monotonic() + self.max_wait_s
        with self._cv:
            while len(group) < self.max_batch:
                for t in list(self._queue):
                    if t.group_key == first.group_key:
                        self._queue.remove(t)
                        group.append(t)
                        if len(group) >= self.max_batch:
                            break
                if len(group) >= self.max_batch:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stop:
                    break
                self._cv.wait(timeout=remaining)
        return group

    def _dispatch(self, group: List[ServeTicket]):
        seeds = [t.seed for t in group]
        prompts = [t.meta_prompt for t in group]
        bucket = next(b for b in self.buckets if b >= len(group))
        pad = bucket - len(group)
        seeds = seeds + [seeds[-1]] * pad
        prompts = prompts + [prompts[-1]] * pad
        # the message rank 0 broadcasts to its followers (with a mesh)
        msg = {"op": "batch", "seeds": seeds, "prompts": prompts, "knobs": dict(group[0].knobs)}
        if self.mesh is not None:
            multihost.broadcast_object(msg)  # the followers make the same call
        pb = _run_lockstep(self.pipe, msg, self.mesh)
        with self._cv:  # snapshot() and handlers read stats concurrently
            self.stats["batches"] += 1
            self.stats["samples"] += bucket
            self.stats["padded_samples"] += pad
            sizes = self.stats["batch_sizes"]
            sizes[bucket] = sizes.get(bucket, 0) + 1
        return pb

    def _loop(self) -> None:
        if self.mesh is None:
            self._serve()
            return
        try:
            self._serve()
        except BaseException as e:  # a lockstep broadcast failed: no follower takes batches any more
            with self._cv:
                self._stop = True
                left, self._queue = list(self._queue), deque()
                self.stats["errors"] += len(left)
            for t in left:
                t._error = e
                t._event.set()
            raise
        finally:
            multihost.broadcast_object({"op": "stop"})

    def _serve(self) -> None:
        while True:
            first = self._pop_first(block=True, timeout=self._idle_tick_s if self.mesh is not None else None)
            if first is None:
                with self._cv:
                    if self._stop and not self._queue:  # stopped, queue drained
                        return
                multihost.broadcast_object({"op": "idle"})
                continue
            group = self._gather(first)
            t0 = time.monotonic()
            try:
                outputs = self._dispatch(group).result()  # the whole generation, then the host copy
            except BaseException as e:  # fail the group, not the server
                with self._cv:
                    self.stats["errors"] += len(group)
                for t in group:
                    t._error = e
                    t._event.set()
                if not isinstance(e, Exception):
                    raise
                continue
            now = time.monotonic()
            with self._cv:  # snapshot() iterates _latencies concurrently
                self.stats["last_batch_s"] = round(now - t0, 3)
                for t in group:
                    self._latencies.append(now - t.submitted_at)
            for t, out in zip(group, outputs):  # padded outputs are dropped
                t._output = out
                t._event.set()


# ----------------------------------------------------------------- HTTP
def _device_info(pipe) -> Dict[str, str]:
    import torch

    dev = pipe.sd.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"device": str(dev), "device_name": name}


def _health(engine: BatchingEngine) -> Dict[str, Any]:
    out = {"ok": True, **_device_info(engine.pipe), "model": engine.pipe.sd.config.name}
    if engine.mesh is not None:
        out["mesh"] = engine.mesh.shape
    return out


def make_server(engine: BatchingEngine, host: str = "127.0.0.1", port: int = 8100,
                request_timeout_s: float = 600.0, artifact_dir=None):
    """Build (not start) the ThreadingHTTPServer around a BatchingEngine.

    ``artifact_dir`` enables per-request artifact trees: a request with
    ``"save_artifacts": true`` gets the final image, run log, attention maps
    and x0 previews written under ``artifact_dir/req%06d`` by its handler
    thread after delivery, and an ``artifacts_path`` field in the response."""
    import contextlib
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from pathlib import Path

    from guided_attention_tpu_torch.runtime.artifacts import write_run_artifacts
    from guided_attention_tpu_torch.runtime.native import png_bytes

    # per-request namespaces: concurrent requests may share (prompt, seed);
    # the counter resumes past trees already on disk, so a restarted server
    # never overwrites the last run's
    start_id = 0
    if artifact_dir is not None:
        existing = [int(p.name[3:]) for p in Path(artifact_dir).glob("req[0-9]*") if p.name[3:].isdigit()]
        start_id = max(existing, default=-1) + 1
    req_ids = itertools.count(start_id)  # next() on it is atomic under the GIL
    # level > 0 writes run matplotlib (a global figure manager): one at a
    # time. Level-0 writes (native PNG pools, VAE decodes) run in parallel.
    artifact_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _send_json(self, code: int, obj: Dict[str, Any]) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json(200, _health(engine))
            elif self.path == "/stats":
                self._send_json(200, engine.snapshot())
            else:
                self._send_json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._send_json(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(payload, dict):
                    raise RequestError("request body must be a JSON object")
                meta_prompt = payload.pop("meta_prompt", "")
                seed = payload.pop("seed", None)
                save_artifacts = bool(payload.pop("save_artifacts", False))
                annotate = bool(payload.pop("annotate", False))
                if save_artifacts:
                    if artifact_dir is None:
                        raise RequestError("save_artifacts requires the server to run with --artifact_dir")
                    # the artifact tree reads the per-step diagnostics: force
                    # them on, over an explicit false
                    payload["capture_diagnostics"] = True
                    if int(payload.get("diagnostic_level", 0)) == 0:
                        # level 0 reads the heavy per-step stacks at steps
                        # [0, 1, 2] only: trim them before the copy
                        payload["trim_heavy_diags"] = True
                    if int(payload.get("diagnostic_level", 0)) > 0:
                        # per-subiteration pred_pre_optim snapshots need the
                        # per-slot latents, as the CLI's run_kwargs wires them
                        payload["capture_eval_latents"] = True
                ticket = engine.submit(meta_prompt, seed=seed, **_coerce_knobs(payload))
            except (OverloadedError, RuntimeError) as e:
                # shut down mid-request, or a device fault in the prepare: retryable
                self._send_json(503, {"error": str(e)})
                return
            except (RequestError, TypeError, ValueError, json.JSONDecodeError) as e:
                self._send_json(400, {"error": str(e)})
                return
            except Exception as e:  # any other server-side fault: a 5xx, never a dropped connection
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                out = ticket.result(timeout=request_timeout_s)
            except TimeoutError as e:
                self._send_json(504, {"error": str(e)})
                return
            except Exception as e:  # the batch failed
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            resp = {
                "seed": ticket.seed,
                "prompt": out.prompt,
                "width": int(out.images_u8.shape[2]),
                "height": int(out.images_u8.shape[1]),
                "image_png_b64": base64.b64encode(png_bytes(out.images_u8[0])).decode(),
            }
            if save_artifacts:
                # the hp the runner derived for this request (request hp or
                # the defaults, then the thresholds knob; runner._prepare_uncached)
                hp = ticket.knobs.get("hp") or HyperParams()
                if ticket.knobs.get("thresholds") is not None:
                    hp = hp.replace(thresholds=ticket.knobs["thresholds"])
                diag = int(ticket.knobs.get("diagnostic_level", 0))
                try:
                    req_dir = Path(artifact_dir) / f"req{next(req_ids):06d}"
                    with artifact_lock if diag > 0 else contextlib.nullcontext():
                        _, image_path, _ = write_run_artifacts(
                            engine.pipe, out, output_path=req_dir, seed=ticket.seed, hp=hp,
                            meta_prompt=ticket.meta_prompt, annotate=annotate, diagnostic_level=diag)
                    resp["artifacts_path"] = str(image_path)
                except Exception as e:  # the image is delivered all the same
                    resp["artifacts_error"] = f"{type(e).__name__}: {e}"
            self._send_json(200, resp)

    return ThreadingHTTPServer((host, port), Handler)


WARMUP_PROMPTS = ("a [robot:.6,.3,.4,.55] and a [vase:0,.3,.4,.55]",
                  "a [robot:0,.1,.45,.5] and a [vase:.55,.4,.4,.5]")


def warmup(engine: BatchingEngine, **knobs) -> None:
    """Serve a request (the default knobs, or ``knobs``) at every bucket,
    one prompt and two: the kernels' first-use build and cuDNN's first
    calls happen here, not in a client's request."""
    wp, wp2 = WARMUP_PROMPTS
    for b in engine.buckets:
        for label, prompts in (("same-prompt", [wp] * b), ("multi-prompt", [(wp if i % 2 else wp2) for i in range(b)])):
            if label == "multi-prompt" and b == 1:
                continue  # a batch of one has one prompt
            t0 = time.monotonic()
            for t in [engine.submit(p, seed=i, **knobs) for i, p in enumerate(prompts)]:
                t.result()
            print(f"warmup bucket {b} ({label}): {time.monotonic() - t0:.1f} s", flush=True)


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="sd15", help="sd14/sd15/sd21/micro")
    p.add_argument("--model_path", default=None, help="local checkpoint dir (random init if omitted)")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8100)
    p.add_argument("--max_wait_ms", type=float, default=100.0)
    p.add_argument("--max_queue", type=int, default=64,
                   help="queue depth limit; excess requests get HTTP 503 (load shedding)")
    p.add_argument("--artifact_dir", default=None,
                   help="enable per-request artifact trees (request field save_artifacts)")
    p.add_argument("--buckets", default="1,2,4,8", help="allowed batch sizes, comma-separated")
    p.add_argument("--mesh_shape", type=json.loads, default=None,
                   help='mesh over the processes of a torchrun launch, one GPU each, e.g. \'{"data": 2}\' or '
                        '\'{"data": 1, "tensor": 2}\'; default over N > 1 processes: {"data": N}. Rank 0 serves, '
                        "the others follow each batch. Every bucket must divide by the data axis.")
    p.add_argument("--warmup", action="store_true",
                   help="serve every bucket size once, one prompt and two, before serving")
    args = p.parse_args(argv)

    import torch

    from guided_attention_tpu_torch.models.bundle import StableDiffusion
    from guided_attention_tpu_torch.parallel.mesh import make_mesh

    multihost.initialize()  # from torchrun's environment; a no-op for one process
    device = multihost.rank_device(args.device)
    mesh = None
    if args.mesh_shape or multihost.process_count() > 1:
        mesh = make_mesh(args.mesh_shape, device=device)
    # on every rank, before the model: a follower must not wait for an engine that refused its buckets
    buckets = _check_buckets(tuple(int(b) for b in args.buckets.split(",")), mesh)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    sd = StableDiffusion.create(args.model, dtype, device=device, checkpoint_dir=args.model_path)
    pipe = GuidedAttentionPipeline(sd)
    if mesh is not None and not multihost.is_primary():
        n = follow(pipe, mesh)
        print(f"rank {multihost.process_index()}: followed {n} batch(es); stopped", flush=True)
        return
    engine = BatchingEngine(pipe, max_wait_ms=args.max_wait_ms, buckets=buckets, mesh=mesh,
                            max_queue=args.max_queue)
    server = None
    try:
        if args.warmup:
            warmup(engine)
        server = make_server(engine, host=args.host, port=args.port, artifact_dir=args.artifact_dir)
        info = _device_info(pipe)
        print(f"guided-attention inference server on http://{args.host}:{server.server_address[1]} "
              f"(buckets {buckets}, wait {args.max_wait_ms:.0f} ms, {info['device']} {info['device_name']}"
              f"{'' if mesh is None else f', mesh {mesh.shape}'})", flush=True)
        server.serve_forever()
    finally:
        if server is not None:
            server.server_close()
        engine.close()


if __name__ == "__main__":
    main()
