// nbody_tpu browser client logic — every non-GL/non-DOM function of the
// visualizer front-end, extracted from index.html so it is testable: no
// JS runtime exists in the build image, so tests/test_browser_client.py
// validates line-for-line Python transliterations of these functions
// (the same executable-spec pattern as sim.js / test_browser_sim.py).
// If a function here changes, the Python port must change with it.
//
// Scope: orbit-camera math and input reducers (reference
// src/render/camera.rs:111-213), the view-projection/billboard basis
// (camera.rs uniform build), the AABB wireframe expansion with the
// depth palette (src/manual/barnes_hut.rs:324-331), the local
// frame-budget loop decisions (vis/server.py SimLoop semantics), and
// the settings-slider transforms (egui panel analog, src/vis.rs:82-280).
"use strict";
const NBodyClient = (() => {

  // ---- small vec/mat helpers (column-major 4x4, GL convention) ----------
  const clamp = (x, a, b) => Math.min(b, Math.max(a, x));
  function neg(a){ return [-a[0], -a[1], -a[2]]; }
  function dot3(a, b){ return a[0]*b[0] + a[1]*b[1] + a[2]*b[2]; }
  function cross(a, b){
    return [a[1]*b[2] - a[2]*b[1],
            a[2]*b[0] - a[0]*b[2],
            a[0]*b[1] - a[1]*b[0]];
  }
  function norm3(a){
    const l = Math.hypot(a[0], a[1], a[2]);
    return [a[0]/l, a[1]/l, a[2]/l];
  }
  function mul44(a, b){  // column-major: o[c][r] = sum_k a[k][r]*b[c][k]
    const o = new Float32Array(16);
    for (let c = 0; c < 4; c++)
      for (let r = 0; r < 4; r++){
        let s = 0;
        for (let k = 0; k < 4; k++) s += a[k*4 + r] * b[c*4 + k];
        o[c*4 + r] = s;
      }
    return o;
  }

  // ---- orbit camera (reference camera.rs:111-213) -----------------------
  const CAM_HOME = { yaw: 0.6, pitch: 0.5, zoom: 1.0 };
  const CAM_DIST = 5.0;      // orbit radius at zoom 1
  const PITCH_LIM = 1.5;     // just inside +-pi/2: no pole flip
  const ZOOM_MIN = 0.1, ZOOM_MAX = 10.0;
  const ORBIT_RATE = 0.01;   // radians per pixel dragged
  const WHEEL_RATE = 0.001;  // exp zoom per wheel delta unit

  // drag orbit: yaw/pitch from a gesture-start snapshot + pixel deltas
  // (absolute from the snapshot, NOT incremental: re-deriving from the
  // start point each move is what makes the gesture jitter-free)
  function orbitFrom(y0, p0, dx, dy){
    return { yaw: y0 + dx * ORBIT_RATE,
             pitch: clamp(p0 + dy * ORBIT_RATE, -PITCH_LIM, PITCH_LIM) };
  }
  function wheelZoom(zoom, deltaY){
    return clamp(zoom * Math.exp(deltaY * WHEEL_RATE), ZOOM_MIN, ZOOM_MAX);
  }
  function pinchZoom(z0, d0, d){
    return clamp(z0 * d0 / Math.max(d, 1e-3), ZOOM_MIN, ZOOM_MAX);
  }

  // touch-state machine: one finger orbits, two pinch; lifting back to
  // one finger re-anchors an orbit at the survivor so there is no jump.
  // touches: [{x, y}, ...]; cam: {yaw, pitch, zoom}.
  const touchDist = t => Math.hypot(t[0].x - t[1].x, t[0].y - t[1].y);
  function touchStart(cam, touches){
    if (touches.length === 1)
      return { mode: 'orbit', sx: touches[0].x, sy: touches[0].y,
               y0: cam.yaw, p0: cam.pitch };
    if (touches.length >= 2)
      return { mode: 'pinch', d0: touchDist(touches), z0: cam.zoom };
    return null;
  }
  function touchMove(st, cam, touches){  // -> partial cam update (or {})
    if (!st) return {};
    if (st.mode === 'orbit' && touches.length === 1)
      return orbitFrom(st.y0, st.p0,
                       touches[0].x - st.sx, touches[0].y - st.sy);
    if (st.mode === 'pinch' && touches.length >= 2)
      return { zoom: pinchZoom(st.z0, st.d0, touchDist(touches)) };
    return {};
  }
  function touchEnd(cam, touches){
    if (touches.length === 0) return null;
    if (touches.length === 1) return touchStart(cam, touches);
    return touchStart(cam, touches);
  }

  // eye position on the orbit sphere (Y up)
  function cameraEye(yaw, pitch, zoom){
    return [Math.cos(pitch) * Math.sin(yaw) * CAM_DIST * zoom,
            Math.sin(pitch) * CAM_DIST * zoom,
            Math.cos(pitch) * Math.cos(yaw) * CAM_DIST * zoom];
  }

  // view-proj + billboard basis. fovY 45deg, zn 0.1, zf 100 — the
  // reference camera's perspective build (camera.rs).
  function cameraMat(yaw, pitch, zoom, aspect){
    const eye = cameraEye(yaw, pitch, zoom);
    const f = norm3(neg(eye));              // look at the origin
    const r = norm3(cross(f, [0, 1, 0]));
    const u = cross(r, f);
    const v = [r[0], u[0], -f[0], 0,
               r[1], u[1], -f[1], 0,
               r[2], u[2], -f[2], 0,
               -dot3(r, eye), -dot3(u, eye), dot3(f, eye), 1];
    const fy = 1 / Math.tan(22.5 * Math.PI / 180);
    const zn = 0.1, zf = 100;
    const p = [fy/aspect, 0, 0, 0,
               0, fy, 0, 0,
               0, 0, (zf + zn)/(zn - zf), -1,
               0, 0, 2*zf*zn/(zn - zf), 0];
    return { vp: mul44(p, v), right: r, up: u };
  }

  // ---- AABB wireframe expansion ----------------------------------------
  // 12 cube edges over corners indexed by the orthant bit convention
  // (bit0=x, bit1=y, bit2=z — matches ops/morton.py)
  const EDGES = [[0,1],[1,3],[3,2],[2,0],[4,5],[5,7],[7,6],[6,4],
                 [0,4],[1,5],[2,6],[3,7]];
  // depth palette, reference src/manual/barnes_hut.rs:324-331: depth
  // fraction s in [0,1] -> rgba
  function boxColor(depthFrac){
    const s = depthFrac * 0.7 + 0.3;
    return [(1 - s*s) * 0.5, s*s, (1 - s) * 0.5, s];
  }
  // f32 records of 7 floats [lo.xyz, hi.xyz, depthFrac] -> line-list
  // vertex + color arrays (24 verts per box)
  function boxGeometry(f32){
    const nb = f32.length / 7 | 0;
    const verts = new Float32Array(nb * 24 * 3);
    const cols = new Float32Array(nb * 24 * 4);
    let vi = 0, ci = 0;
    for (let b = 0; b < nb; b++){
      const lo = [f32[b*7], f32[b*7+1], f32[b*7+2]];
      const hi = [f32[b*7+3], f32[b*7+4], f32[b*7+5]];
      const col = boxColor(f32[b*7+6]);
      const corner = i => [i & 1 ? hi[0] : lo[0],
                           i & 2 ? hi[1] : lo[1],
                           i & 4 ? hi[2] : lo[2]];
      for (const [a, bb] of EDGES){
        for (const c of [corner(a), corner(bb)]){
          verts[vi++] = c[0]; verts[vi++] = c[1]; verts[vi++] = c[2];
          cols[ci++] = col[0]; cols[ci++] = col[1];
          cols[ci++] = col[2]; cols[ci++] = col[3];
        }
      }
    }
    return { verts, cols, nVerts: nb * 24 };
  }

  // ---- local frame-budget loop decisions -------------------------------
  // Pure versions of SimLoop's stepping policy (vis/server.py run()):
  // one step always; keep stepping while the remaining frame budget fits
  // another step of the current measured cost, capped at maxSteps.
  function shouldStepAgain(elapsedMs, stepTimeMs, maxFps, did, maxSteps){
    return elapsedMs + stepTimeMs < 1000 / maxFps && did < maxSteps;
  }
  // per-step cost estimate: first sample taken as-is, then EMA(0.7/0.3)
  function emaStepTime(prev, sampleMs, isFirst){
    return isFirst ? sampleMs : 0.7 * prev + 0.3 * sampleMs;
  }
  // fps over a ring of frame-to-frame wall periods (ms) — the reference's
  // 60-sample ring (src/vis.rs:53-68); same semantics as SimLoop.fps()
  function ringFps(frameTimesMs){
    if (!frameTimesMs.length) return 0;
    let s = 0;
    for (const t of frameTimesMs) s += t;
    return 1000 * frameTimesMs.length / Math.max(s, 1e-6);
  }
  // sleep until the next frame boundary (ms); never negative
  function frameSleep(elapsedMs, maxFps){
    return Math.max(0, 1000 / maxFps - elapsedMs);
  }

  // ---- settings sliders -------------------------------------------------
  // [rangeId, valueId, settingsKey, sliderToValue, format]; dt rides a
  // log10 slider (the egui panel's log-scale dt, src/vis.rs:82-280)
  const SLIDERS = [
    ['r_fps', 'v_fps', 'max_fps', x => x, x => x.toFixed(0)],
    ['r_spf', 'v_spf', 'max_steps_per_frame', x => x, x => x.toFixed(0)],
    ['r_dt', 'v_dt', 'dt', x => Math.pow(10, x), x => x.toExponential(1)],
    ['r_g', 'v_g', 'g', x => x, x => (+x).toFixed(2)],
    ['r_soft', 'v_soft', 'g_soft', x => x, x => (+x).toFixed(3)],
    ['r_th', 'v_th', 'theta2', x => x, x => (+x).toFixed(2)],
  ];
  // settings value -> slider position (inverse of sliderToValue)
  function sliderPosition(key, value){
    return key === 'dt' ? Math.log10(Math.max(value, 1e-6)) : value;
  }

  return { clamp, neg, dot3, cross, norm3, mul44,
           CAM_HOME, CAM_DIST, PITCH_LIM, ZOOM_MIN, ZOOM_MAX,
           ORBIT_RATE, WHEEL_RATE,
           orbitFrom, wheelZoom, pinchZoom,
           touchDist, touchStart, touchMove, touchEnd,
           cameraEye, cameraMat,
           EDGES, boxColor, boxGeometry,
           shouldStepAgain, emaStepTime, ringFps, frameSleep,
           SLIDERS, sliderPosition };
})();
if (typeof module !== 'undefined') module.exports = NBodyClient;
