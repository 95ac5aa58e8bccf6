"""Live progressive-render viewer (port of the JAX package's ``viewer.py``).

The reference drives an SDL window with an ImGui panel (render stats, tracer
params, camera, environment — ``src/vk_engine.cpp:1492-1621``) and WASD/mouse
camera motion that pauses progressive accumulation
(``vk_engine.cpp:1817-1904``).  This is the headless-friendly equivalent: a
stdlib HTTP server around a :class:`ProgressiveRenderer` — a background
thread accumulates frames; the browser polls the PNG and posts camera /
parameter changes, which reset accumulation exactly like the reference's
camera moves.  One render thread and the HTTP threads share the device;
PNGs are written by ``integrator/film.py::encode_png`` (no Pillow).

    python -m ray_tracer_tpu_torch.cli view --preset sphere_diffuse --cpu
"""

from __future__ import annotations

import json
import threading
import time
from typing import Optional

import numpy as np
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .api import ProgressiveRenderer
from .config import RenderConfig
from .integrator import film
from .scene.types import Camera

PNG_LEVEL = 0  # zlib level of the published frames: stored, not deflated

_PAGE = """<!doctype html>
<html><head><title>ray_tracer_tpu_torch</title><style>
body{background:#111;color:#ddd;font-family:monospace;display:flex;gap:20px;padding:16px}
img{image-rendering:pixelated;border:1px solid #444}
label{display:block;margin:6px 0 2px}input{width:90px;background:#222;color:#ddd;border:1px solid #555}
button{margin-top:10px;background:#333;color:#eee;border:1px solid #666;padding:4px 12px}
#stats{margin-top:14px;color:#8c8}
</style></head><body>
<div><img id="view" width="512" height="512"/></div>
<div>
  <b>camera</b>
  <label>pos x/y/z</label>
  <input id="px" step="0.1" type="number"/><input id="py" step="0.1" type="number"/><input id="pz" step="0.1" type="number"/>
  <label>pitch / yaw / roll (deg)</label>
  <input id="ax" step="1" type="number"/><input id="ay" step="1" type="number"/><input id="az" step="1" type="number"/>
  <label>fov</label><input id="fov" step="1" type="number"/>
  <button onclick="apply()">apply (resets accumulation)</button>
  <div id="stats"></div>
  <div style="margin-top:10px;color:#888">WASD+QE move, arrows rotate</div>
  <hr style="border-color:#333"/>
  <b>debug view</b>
  <div>
    <button onclick="dbg(0)">box tests</button>
    <button onclick="dbg(1)">tri tests</button>
    <button onclick="dbg(2)">combined</button>
    <button onclick="dbg(-1)">render</button>
  </div>
  <hr style="border-color:#333"/>
  <b>material editor</b>
  <label>material</label><select id="msel" onchange="mload()"></select>
  <label>albedo r/g/b</label>
  <input id="m_ar" step="0.05" type="number"/><input id="m_ag" step="0.05" type="number"/><input id="m_ab" step="0.05" type="number"/>
  <label>emission strength / reflectance / ior</label>
  <input id="m_es" step="0.1" type="number"/><input id="m_rf" step="0.1" type="number"/><input id="m_io" step="0.05" type="number"/>
  <button onclick="mapply()">update material</button>
  <div id="sphdiv">
  <b>sphere editor</b>
  <label>sphere</label><select id="ssel" onchange="sload()"></select>
  <label>pos x/y/z</label>
  <input id="s_px" step="0.05" type="number"/><input id="s_py" step="0.05" type="number"/><input id="s_pz" step="0.05" type="number"/>
  <label>radius / material</label>
  <input id="s_r" step="0.05" type="number"/><input id="s_m" step="1" type="number"/>
  <button onclick="sapply()">update sphere</button>
  </div>
  <b>environment</b>
  <label>sun intensity / focus / enabled</label>
  <input id="e_si" step="1" type="number"/><input id="e_sf" step="50" type="number"/><input id="e_on" type="checkbox" style="width:auto"/>
  <button onclick="eapply()">update environment</button>
</div>
<script>
let SCENE=null, DBG=-1;
async function refresh(){
  const img=document.getElementById('view');
  img.src=(DBG<0?'/image.png?t=':'/debug.png?mode='+DBG+'&t=')+Date.now();
  const s=await (await fetch('/stats')).json();
  document.getElementById('stats').innerText=
    `frame ${s.frame}  spp ${s.total_samples}  ${s.frame_ms.toFixed(0)} ms/frame`+
    (s.preview?'  [preview]':'');
  if(!window._init){
    for(const [k,v] of Object.entries(s.camera)) {
      const el=document.getElementById(k); if(el) el.value=v.toFixed(2);
    }
    window._init=true;
    sceneload();
  }
}
function dbg(m){DBG=m;}
async function sceneload(){
  SCENE=await (await fetch('/scene')).json();
  if(!SCENE.editable) return;
  const ms=document.getElementById('msel');
  ms.innerHTML=SCENE.materials.map((m,i)=>`<option value="${i}">${i}: ${m.name||'mat'+i}</option>`).join('');
  const ss=document.getElementById('ssel');
  ss.innerHTML=SCENE.spheres.map((s,i)=>`<option value="${i}">sphere ${i}</option>`).join('');
  document.getElementById('sphdiv').style.display=SCENE.spheres.length?'block':'none';
  mload(); sload();
  document.getElementById('e_si').value=SCENE.environment.sun_intensity;
  document.getElementById('e_sf').value=SCENE.environment.sun_focus;
  document.getElementById('e_on').checked=SCENE.environment.enabled;
}
function mload(){
  const m=SCENE.materials[+document.getElementById('msel').value]; if(!m) return;
  [['m_ar',m.albedo[0]],['m_ag',m.albedo[1]],['m_ab',m.albedo[2]],
   ['m_es',m.emission_strength],['m_rf',m.reflectance],['m_io',m.ior]]
   .forEach(([k,v])=>document.getElementById(k).value=v);
}
function sload(){
  const s=(SCENE.spheres||[])[+document.getElementById('ssel').value]; if(!s) return;
  [['s_px',s.position[0]],['s_py',s.position[1]],['s_pz',s.position[2]],
   ['s_r',s.radius],['s_m',s.material]]
   .forEach(([k,v])=>document.getElementById(k).value=v);
}
function g(k){return parseFloat(document.getElementById(k).value);}
async function edit(doc){
  await fetch('/edit',{method:'POST',body:JSON.stringify(doc)});
  sceneload();
}
function mapply(){
  const i=document.getElementById('msel').value;
  edit({materials:{[i]:{albedo:[g('m_ar'),g('m_ag'),g('m_ab')],
    emission_strength:g('m_es'),reflectance:g('m_rf'),ior:g('m_io')}}});
}
function sapply(){
  const i=document.getElementById('ssel').value;
  edit({spheres:{[i]:{position:[g('s_px'),g('s_py'),g('s_pz')],
    radius:g('s_r'),material:g('s_m')}}});
}
function eapply(){
  edit({environment:{sun_intensity:g('e_si'),sun_focus:g('e_sf'),
    enabled:document.getElementById('e_on').checked}});
}
function apply(){
  const q=['px','py','pz','ax','ay','az','fov'].map(k=>k+'='+document.getElementById(k).value).join('&');
  fetch('/set?'+q); window._init=false;
}
document.addEventListener('keydown',e=>{
  const d={w:'pz',s:'pz',a:'px',d:'px',q:'py',e:'py'}[e.key];
  const r={ArrowUp:'ax',ArrowDown:'ax',ArrowLeft:'ay',ArrowRight:'ay'}[e.key];
  if(d){const el=document.getElementById(d);
    el.value=(parseFloat(el.value)+( 'wdq'.includes(e.key)?0.2:-0.2)).toFixed(2);apply();}
  if(r){const el=document.getElementById(r);
    el.value=(parseFloat(el.value)+((e.key=='ArrowUp'||e.key=='ArrowLeft')?-5:5)).toFixed(2);apply();}
});
setInterval(refresh, 800); refresh();
</script></body></html>"""


class ViewerState:
    """The viewer's state: the progressive renderer, its preview, the
    published PNG and the live editors.

    ``lock`` guards the renderers: ``_tick`` holds it while it renders and
    publishes a frame, and every request that reads or resets a renderer
    takes it, so no request reads a tensor that ``_tick`` is writing.
    ``edit_lock`` serializes whole edit transactions (mutate the builder,
    recompile, swap the scene)."""

    def __init__(self, scene, cfg: RenderConfig, preview_scale: int = 4,
                 device=None):
        from .scene.builder import SceneBuilder

        self.lock = threading.Lock()
        self.edit_lock = threading.Lock()
        # Accepting the BUILDER (not just the compiled scene) is what makes
        # live editing possible: edits mutate builder descriptors and
        # recompile, the analogue of the reference's ImGui editors +
        # update_buffer re-upload (vk_engine.cpp:1541-1603).  A builder
        # compiles on ``device`` (default: the CUDA device), a compiled
        # scene stays where it is, and edits recompile on the scene's
        # device.
        self.builder = scene if isinstance(scene, SceneBuilder) else None
        compiled = (
            self.builder.compile(device=device) if self.builder else scene
        )
        self.device = compiled.device
        self.renderer = ProgressiveRenderer(compiled, cfg)
        # Instant low-res preview: the first frame after any camera move /
        # edit renders at 1/preview_scale resolution, 1 spp and at most
        # two bounces, so the view tracks interaction even where a
        # full-res frame takes long.  The reference gets the same effect
        # by pausing accumulation and re-rendering 1-spp full-res frames
        # during movement (vk_engine.cpp:1867-1891).  The browser upscales
        # the small PNG (pixelated).
        self.preview = None
        if preview_scale > 1:
            pcfg = cfg.replace(
                width=max(16, cfg.width // preview_scale),
                height=max(16, cfg.height // preview_scale),
                samples_per_pixel=1,
                bounce_limit=min(cfg.bounce_limit, 2),
            )
            self.preview = ProgressiveRenderer(
                compiled, pcfg, camera=self.renderer.camera
            )
        self.cfg = cfg
        self.frame_ms = 0.0
        self.edits = 0
        self.running = True
        self.latest_png: Optional[bytes] = None
        self.latest_is_preview = False

    def _encode(self, accum) -> bytes:
        # every tick publishes a PNG, and deflating a 1920x1080 frame at
        # zlib level 6 takes longer than rendering it (PERF.md §6), so the
        # frames are stored
        return film.encode_png(accum, level=PNG_LEVEL)

    def _tick(self):
        """One render step: the low-res preview right after a reset, the
        full-res accumulation frame otherwise.  Publishes the encoded PNG
        so /image.png never blocks behind a multi-second frame."""
        with self.lock:
            t0 = time.perf_counter()
            if (
                self.preview is not None
                and self.renderer.frame == 0
                and self.preview.frame == 0
            ):
                self.preview.step()
                self.latest_png = self._encode(self.preview.accum)
                self.latest_is_preview = True
            else:
                self.renderer.step()
                self.latest_png = self._encode(self.renderer.accum)
                self.latest_is_preview = False
            self.frame_ms = (time.perf_counter() - t0) * 1e3

    def loop(self):
        while self.running:
            self._tick()

    def png_bytes(self) -> bytes:
        png = self.latest_png  # atomic reference read (GIL)
        if png is not None:
            return png
        with self.lock:
            return self._encode(self.renderer.accum)

    def stats(self) -> dict:
        cam = self.renderer.camera
        return {
            "frame": self.renderer.frame,
            "total_samples": self.renderer.total_samples,
            "frame_ms": self.frame_ms,
            "preview": self.latest_is_preview,
            "camera": {
                "px": cam.position[0], "py": cam.position[1], "pz": cam.position[2],
                "ax": cam.angles_deg[0], "ay": cam.angles_deg[1], "az": cam.angles_deg[2],
                "fov": cam.fov,
            },
        }

    def set_camera(self, q: dict):
        cam = self.renderer.camera
        g = lambda k, d: float(q.get(k, [d])[0])
        new = Camera(
            position=(g("px", cam.position[0]), g("py", cam.position[1]),
                      g("pz", cam.position[2])),
            angles_deg=(g("ax", cam.angles_deg[0]), g("ay", cam.angles_deg[1]),
                        g("az", cam.angles_deg[2])),
            fov=g("fov", cam.fov),
            near_plane=cam.near_plane,
        )
        with self.lock:
            self.renderer.move_camera(new)
            if self.preview is not None:
                self.preview.move_camera(new)

    # -- live scene editing (reference imgui_draw editors,
    # vk_engine.cpp:1522-1603) ------------------------------------------
    def scene_doc(self) -> dict:
        """Editable scene description for the panel."""
        if self.builder is None:
            return {"editable": False}
        from .scene import schema

        doc = schema.builder_to_dict(self.builder)
        doc["editable"] = True
        doc["instances"] = [
            {"index": k, "name": inst.name, "material": inst.material}
            for k, (_, inst) in enumerate(self.builder.instances)
        ]
        doc["edits"] = self.edits
        return doc

    def apply_edit(self, doc: dict) -> dict:
        """Apply material/sphere/instance/environment edits, recompile, and
        restart accumulation.

        The reference patches GPU buffers in place (update_buffer,
        vk_engine.cpp:1545,1572,1594-1603); here material parameters are
        baked into the packed shading rows, so the scene compiler re-runs —
        sub-second for preset-scale scenes, and TRS edits rebuild the BVH
        (which the reference's per-object forest never has to, quirk Q11).
        """
        if self.builder is None:
            return {"error": "viewer was started without a SceneBuilder"}
        with self.edit_lock:
            return self._apply_edit_locked(doc)

    def _apply_edit_locked(self, doc: dict) -> dict:
        from .scene.types import SphereDesc
        from .utils.transforms import trs_matrix

        b = self.builder
        for k, m in (doc.get("materials") or {}).items():
            mat = b.materials[int(k)]
            for f in ("albedo", "emission_color"):
                if f in m:
                    setattr(mat, f, tuple(float(x) for x in m[f]))
            for f in ("emission_strength", "reflectance", "ior"):
                if f in m:
                    setattr(mat, f, float(m[f]))
        for k, s in (doc.get("spheres") or {}).items():
            old = b.spheres[int(k)]
            b.spheres[int(k)] = SphereDesc(
                position=tuple(
                    float(x) for x in s.get("position", old.position)
                ),
                radius=float(s.get("radius", old.radius)),
                material=int(s.get("material", old.material)),
            )
        for k, o in (doc.get("instances") or {}).items():
            _, inst = b.instances[int(k)]
            if "material" in o:
                inst.material = int(o["material"])
            if "trs" in o:
                t = o["trs"]
                inst.transform = trs_matrix(
                    t.get("position", (0, 0, 0)),
                    t.get("rotation_deg", (0, 0, 0)),
                    t.get("scale", (1, 1, 1)),
                )
        if "environment" in doc:
            e = doc["environment"]
            env = b.environment
            for f in (
                "horizon_color", "zenith_color", "ground_color", "light_dir",
            ):
                if f in e:
                    setattr(env, f, tuple(float(x) for x in e[f]))
            for f in ("sun_focus", "sun_intensity"):
                if f in e:
                    setattr(env, f, float(e[f]))
            if "enabled" in e:
                env.enabled = bool(e["enabled"])

        compiled = b.compile(device=self.device)
        with self.lock:
            self.renderer.set_scene(compiled)
            if self.preview is not None:
                self.preview.set_scene(compiled)
            self.edits += 1
        return {"ok": True, "edits": self.edits}

    def debug_png(self, mode: int, box_cap: float, tri_cap: float) -> bytes:
        """Full-path BVH heatmap of the current view (reference debug modes
        0/1/2, raytrace.comp:583-591 + ImGui toggle vk_engine.cpp:1512-16),
        at half resolution / 1 spp to keep the counting walk interactive.
        Written as the JAX viewer writes it: the heatmap's values scaled
        to 8 bits, truncated, with no sRGB transform."""
        from .api import render_debug

        cfg = self.cfg.replace(
            width=max(8, self.cfg.width // 2),
            height=max(8, self.cfg.height // 2),
            samples_per_pixel=1,
        )
        with self.lock:
            img = render_debug(
                self.renderer.scene, cfg, camera=self.renderer.camera,
                mode=mode, box_cap=box_cap, tri_cap=tri_cap,
            )
        arr = (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        return film.encode_png_uint8(arr, PNG_LEVEL)


def _make_server(
    state: "ViewerState", host: str, port: int
) -> ThreadingHTTPServer:
    """The viewer's HTTP server around an existing state (separated from
    :func:`serve` so tests exercise the real endpoint handlers)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                self._send(200, "text/html", _PAGE.encode())
            elif url.path == "/image.png":
                self._send(200, "image/png", state.png_bytes())
            elif url.path == "/stats":
                self._send(200, "application/json", json.dumps(state.stats()).encode())
            elif url.path == "/scene":
                self._send(
                    200, "application/json",
                    json.dumps(state.scene_doc()).encode(),
                )
            elif url.path == "/debug.png":
                q = parse_qs(url.query)
                g = lambda k, d: float(q.get(k, [d])[0])
                self._send(
                    200, "image/png",
                    state.debug_png(
                        int(g("mode", 2)), g("boxcap", 200.0), g("tricap", 50.0)
                    ),
                )
            elif url.path == "/set":
                state.set_camera(parse_qs(url.query))
                self._send(200, "application/json", b"{}")
            else:
                self._send(404, "text/plain", b"not found")

        def do_POST(self):
            url = urlparse(self.path)
            if url.path == "/edit":
                n = int(self.headers.get("Content-Length", 0))
                try:
                    doc = json.loads(self.rfile.read(n) or b"{}")
                    out = state.apply_edit(doc)
                except (ValueError, KeyError, IndexError) as e:
                    out = {"error": str(e)}
                code = 200 if "error" not in out else 400
                self._send(code, "application/json", json.dumps(out).encode())
            else:
                self._send(404, "text/plain", b"not found")

    return ThreadingHTTPServer((host, port), Handler)


def serve(
    scene,
    cfg: RenderConfig,
    port: int = 8787,
    host: str = "127.0.0.1",
    device=None,
) -> None:
    """Serve the live viewer. Binds loopback-only by default — the /set and
    /edit endpoints mutate scene/camera state, so exposing them beyond the
    machine must be an explicit choice (``host="0.0.0.0"`` / ``--host``).

    ``scene`` may be a :class:`SceneBuilder` (enables the live material /
    sphere / TRS / environment editors) or an already-compiled scene
    (view-only); a builder compiles on ``device`` (default: the CUDA
    device)."""
    state = ViewerState(scene, cfg, device=device)
    thread = threading.Thread(target=state.loop, daemon=True)
    thread.start()

    server = _make_server(state, host, port)
    print(f"viewer at http://localhost:{port}/  (ctrl-c to stop)")
    try:
        server.serve_forever()
    finally:
        state.running = False
