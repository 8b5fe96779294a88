"""Interactive web UI backend (the CLI's ``--interactive``).

Counterpart of the JAX package's ``frontends/gui.py``, with the reference
Flask app's protocol (reference gui.py:14-45):
  GET  /                   -> the annotation UI page (``web/ui.html``)
  POST /execute_function   -> {"variable1": meta_prompt} runs one generation
                              with a random seed, returns {"result": path}
  GET  /static/output.png  -> the last generated image
  every response carries Cache-Control: no-store

On the stdlib ThreadingHTTPServer. Each request builds its own spec and
goes through the serving engine (``frontends/server.BatchingEngine``), so
two users who submit at once share one batch. Artifact writing (the
reference's per-seed output block) is serialised: matplotlib's figure
manager, used at ``diagnostic_level > 0``, is not thread-safe.

Over several processes, one GPU each (``parallel/``), rank 0 serves the UI
through an engine over the mesh and every other rank follows its batches
(``frontends/server.follow``); the CLI arranges both.
"""
from __future__ import annotations

import json
import random
import shutil
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

WEB_DIR = Path(__file__).parent / "web"


def _config_knobs(config, base_hp):
    """RunConfig -> the engine's generation knobs (the CLI's run_kwargs;
    capture_diagnostics on for the artifact tree)."""
    return dict(
        num_inference_steps=config.n_inference_steps,
        guidance_scale=config.guidance_scale,
        max_iter_to_alter=config.max_iter_to_alter,
        attention_res=config.attention_res,
        run_standard_sd=config.run_standard_sd,
        hp=base_hp,
        scale_factor=config.scale_factor,
        scale_range=config.scale_range,
        smooth_attentions=config.smooth_attentions,
        sigma=config.sigma,
        kernel_size=config.kernel_size,
        sd_2_1=config.sd_2_1,
        only_update_on_threshold_steps=config.only_update_on_threshold_steps,
        sub_prompt_avg_within=config.sub_prompt_avg_within,
        skip_inert_guidance_passes=config.skip_inert_guidance_passes,
        diagnostic_level=config.diagnostic_level,
        capture_eval_maps=config.save_all_maps,
        capture_eval_latents=config.diagnostic_level > 0,
        eta=config.eta,
        capture_diagnostics=True,
        # level-0 artifacts read the heavy per-step stacks at steps [0, 1, 2]
        # only (save_individual_ca_maps needs the full latent_in)
        trim_heavy_diags=config.diagnostic_level == 0 and not config.save_individual_ca_maps,
    )


def run_server(config, pipe, host: str = "127.0.0.1", port: int = 5000, once: bool = False, engine=None,
               max_wait_ms: float = 150.0, mesh=None):
    """Serve the interactive UI; ``once`` handles one request and returns.
    ``engine`` shares a BatchingEngine (co-hosting with the inference
    server); otherwise one with the default buckets is made (over
    ``mesh``: the default buckets times its data axis), and closed on
    return."""
    from guided_attention_tpu_torch.annotation import parse_prompt
    from guided_attention_tpu_torch.config import HyperParams
    from guided_attention_tpu_torch.frontends.server import BatchingEngine, OverloadedError
    from guided_attention_tpu_torch.runtime.artifacts import write_run_artifacts

    own_engine = engine is None
    if own_engine:
        data = 1 if mesh is None else mesh.shape.get("data", 1)
        engine = BatchingEngine(pipe, max_wait_ms=max_wait_ms, buckets=tuple(data * b for b in (1, 2, 4, 8)),
                                mesh=mesh)
    static_dir = config.output_path / "static"
    static_dir.mkdir(parents=True, exist_ok=True)
    artifact_lock = threading.Lock()

    # the CLI sweep's precedence (reference run.py:75-79, shared_state.py:21):
    # the base state's thresholds override RunConfig's unless --thresholds
    # was given
    base_hp = HyperParams()
    if getattr(config, "_thresholds_explicit", False):
        base_hp = base_hp.replace(thresholds=dict(config.thresholds))

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def _send_error(self, code, text: str):
            self._send(code, json.dumps({"error": text}).encode(), "application/json")

        def log_message(self, fmt, *args):
            pass

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._send(200, (WEB_DIR / "ui.html").read_bytes(), "text/html; charset=utf-8")
            elif self.path.startswith("/static/output.png"):
                p = static_dir / "output.png"
                if p.exists():
                    self._send(200, p.read_bytes(), "image/png")
                else:
                    self._send(404, b"no output yet", "text/plain")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/execute_function":
                self._send(404, b"not found", "text/plain")
                return
            try:
                # request validation only (bad JSON, a malformed meta-prompt):
                # a 400 the page can show; later faults are the server's (500)
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
                meta_prompt = payload.get("variable1", "")
                parse_prompt(meta_prompt, pipe.registry.as_dict())
            except (ValueError, KeyError, TypeError, AttributeError) as e:
                self._send_error(400, str(e))
                return
            try:
                seed = int(random.randrange(4294967294))  # reference gui.py:29
                out = engine.submit(meta_prompt, seed=seed, **_config_knobs(config, base_hp)).result(timeout=600)
                with artifact_lock:
                    _, image_path, _ = write_run_artifacts(
                        pipe, out, output_path=config.output_path, seed=seed, hp=base_hp, meta_prompt=meta_prompt,
                        interactive=True, annotate=config.annotate,
                        save_cross_attention_maps=config.save_cross_attention_maps,
                        diagnostic_level=config.diagnostic_level, save_all_maps=config.save_all_maps,
                        save_individual_ca_maps_flag=config.save_individual_ca_maps)
                    shutil.copyfile(str(image_path), static_dir / "output.png")
            except OverloadedError as e:
                self._send_error(503, str(e))
                return
            except Exception as e:  # a server-side failure, never a dropped connection
                self._send_error(500, f"{type(e).__name__}: {e}")
                return
            self._send(200, json.dumps({"result": str(image_path)}).encode(), "application/json")

    server = ThreadingHTTPServer((host, port), Handler)
    print(f"guided-attention web UI on http://{host}:{server.server_address[1]}", flush=True)
    try:
        if once:
            server.handle_request()
        else:
            server.serve_forever()
    finally:
        server.server_close()
        if own_engine:
            engine.close()
    return server
