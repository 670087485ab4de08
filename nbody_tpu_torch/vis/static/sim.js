/* In-browser N-body engine — the analog of the reference's WASM run-mode
 * (reference Cargo.toml:33-46 wasm-bindgen/web-sys targets; src/vis.rs:384-412
 * runs the whole Simulation client-side in the browser event loop).  The TPU
 * framework's flagship path streams positions from a Python host
 * (vis/server.py), but when no host is reachable (page opened from disk, or
 * ?local=1) the visualizer runs THIS engine instead: the same disc scene,
 * step_by sequence, leapfrog integrator, open-boundary cull, and a
 * Barnes-Hut octree with theta^2 acceptance — all in plain JS so the page is
 * fully self-contained, like the reference's wasm32 build.
 *
 * Fidelity notes:
 *  - scene: the exact disc formulas of nbody_tpu/scenes/disc.py (reference
 *    src/main.rs:52-89) with a seeded xoshiro-style PRNG (stream differs
 *    from numpy's PCG64 — same distribution, different draws).
 *  - step: half drift -> cull -> force -> kick + half drift, matching
 *    core/stepper.py (reference src/manual/brute_force.rs:84-90).  The cull
 *    here is a literal retain() — the browser build has no XLA static-shape
 *    constraint, so it mirrors the reference's Vec::retain deletion
 *    (src/shared.rs:95-101) directly.
 *  - force: pointer-octree Barnes-Hut, monopole nodes, width^2 <
 *    theta^2 * d^2 acceptance (reference src/manual/barnes_hut.rs walk);
 *    theta2 = 0 degenerates to exact summation.  Plummer softening via
 *    g_soft exactly like engines/brute_force.py.
 */
"use strict";

// ---- seeded PRNG (splitmix64-seeded xoshiro128**) --------------------------
function makeRng(seed) {
  let a = 0x9e3779b9 ^ seed, b = 0x243f6a88 ^ (seed << 13),
      c = 0xb7e15162 ^ (seed >> 7), d = 0xdeadbeef + seed;
  // warm up past the weak seed state
  for (let i = 0; i < 16; i++) next();
  function next() {
    const t = b << 9;
    let r = a * 5; r = ((r << 7) | (r >>> 25)) * 9;
    c ^= a; d ^= b; b ^= c; a ^= d; c ^= t;
    d = (d << 11) | (d >>> 21);
    return (r >>> 0) / 4294967296;
  }
  return next;
}

// ---- disc scene (scenes/disc.py parity) ------------------------------------
function makeDisc(n, seed, boxWidth, discMass, starMass) {
  boxWidth = boxWidth || 10.0; discMass = discMass || 0.2;
  starMass = starMass === undefined ? 1.0 : starMass;
  const rng = makeRng(seed | 0);
  const N = n + 1;
  const pos = new Float64Array(N * 3), vel = new Float64Array(N * 3),
        mass = new Float64Array(N);
  const amax = boxWidth / 2 / 1.2, amin = boxWidth / 10;
  mass[0] = starMass;
  const pm = discMass / n;
  for (let i = 1; i < N; i++) {
    const ua = rng();
    const a = Math.pow((Math.pow(amax, -0.5) - Math.pow(amin, -0.5)) * ua
                       + Math.pow(amin, -0.5), -2);
    const phi = rng() * 2 * Math.PI;
    pos[i * 3] = a * Math.cos(phi);
    pos[i * 3 + 1] = a * Math.sin(phi);
    pos[i * 3 + 2] = a * rng() * 1e-3 - 5e-4;
    const mu = 1 + discMass * (Math.pow(a, -1.5) - Math.pow(amin, -1.5)) /
                             (Math.pow(amax, -1.5) - Math.pow(amin, -1.5));
    const v = Math.sqrt(mu / a);
    vel[i * 3] = v * Math.sin(phi);
    vel[i * 3 + 1] = -v * Math.cos(phi);
    mass[i] = pm;
  }
  return { pos, vel, mass, n: N };
}

// ---- Barnes-Hut octree ------------------------------------------------------
// Flat arrays-of-nodes arena (no per-node objects: one build allocation per
// step at a stable size keeps the JS GC quiet).  Each node: child base index
// (-1 leaf), particle index (-1 internal/empty), COM xyz, total mass, center
// xyz, half-width.
function Octree(cap) {
  const maxNodes = Math.max(64, cap * 4);
  this.child = new Int32Array(maxNodes);   // base of 8 children or -1
  this.pidx = new Int32Array(maxNodes);    // leaf particle or -1
  this.comx = new Float64Array(maxNodes);
  this.comy = new Float64Array(maxNodes);
  this.comz = new Float64Array(maxNodes);
  this.m = new Float64Array(maxNodes);
  this.cx = new Float64Array(maxNodes);
  this.cy = new Float64Array(maxNodes);
  this.cz = new Float64Array(maxNodes);
  this.hw = new Float64Array(maxNodes);
  this.nNodes = 0;
  this.stack = new Int32Array(2048);
}

Octree.prototype.grow = function () {
  // deep split chains (near-coincident particles) can exceed the initial
  // arena guess — double it, keeping contents
  const size = this.pidx.length * 2;
  const copy = (arr, T) => { const g = new T(size); g.set(arr); return g; };
  this.child = copy(this.child, Int32Array);
  this.pidx = copy(this.pidx, Int32Array);
  this.comx = copy(this.comx, Float64Array);
  this.comy = copy(this.comy, Float64Array);
  this.comz = copy(this.comz, Float64Array);
  this.m = copy(this.m, Float64Array);
  this.cx = copy(this.cx, Float64Array);
  this.cy = copy(this.cy, Float64Array);
  this.cz = copy(this.cz, Float64Array);
  this.hw = copy(this.hw, Float64Array);
};

Octree.prototype.alloc = function (cx, cy, cz, hw) {
  const i = this.nNodes++;
  if (i >= this.pidx.length) this.grow();
  this.child[i] = -1; this.pidx[i] = -1; this.m[i] = 0;
  this.comx[i] = 0; this.comy[i] = 0; this.comz[i] = 0;
  this.cx[i] = cx; this.cy[i] = cy; this.cz[i] = cz; this.hw[i] = hw;
  return i;
};

Octree.prototype.build = function (pos, mass, n, center, halfWidth) {
  this.nNodes = 0;
  const root = this.alloc(center[0], center[1], center[2], halfWidth);
  for (let p = 0; p < n; p++) this.insert(root, pos, mass, p, 0);
  this.finalize(root);
  return root;
};

const MAX_DEPTH = 32;

Octree.prototype.insert = function (node, pos, mass, p, depth) {
  for (;;) {
    if (this.pidx[node] === -1 && this.child[node] === -1) {
      this.pidx[node] = p;                       // empty leaf: take it
      this.m[node] = mass[p];
      this.comx[node] = pos[p * 3]; this.comy[node] = pos[p * 3 + 1];
      this.comz[node] = pos[p * 3 + 2];
      return;
    }
    if (this.child[node] === -1) {
      // occupied leaf: split (or stack coincident points at max depth)
      if (depth >= MAX_DEPTH) {
        const m0 = this.m[node], m1 = mass[p], mt = m0 + m1;
        if (mt > 0) {
          this.comx[node] = (this.comx[node] * m0 + pos[p * 3] * m1) / mt;
          this.comy[node] = (this.comy[node] * m0 + pos[p * 3 + 1] * m1) / mt;
          this.comz[node] = (this.comz[node] * m0 + pos[p * 3 + 2] * m1) / mt;
        }
        this.m[node] = mt;
        return;
      }
      const q = this.pidx[node];
      const base = this.nNodes;
      const h = this.hw[node] / 2;
      for (let k = 0; k < 8; k++) {
        this.alloc(this.cx[node] + ((k & 1) ? h : -h),
                   this.cy[node] + ((k & 2) ? h : -h),
                   this.cz[node] + ((k & 4) ? h : -h), h);
      }
      this.child[node] = base;
      this.pidx[node] = -1;
      this.m[node] = 0;          // re-accumulated by finalize
      // reinsert the displaced particle one level down
      this.insert(base + this.octant(node, pos, q), pos, mass, q, depth + 1);
    }
    node = this.child[node] + this.octant(node, pos, p);
    depth++;
  }
};

Octree.prototype.octant = function (node, pos, p) {
  return (pos[p * 3] > this.cx[node] ? 1 : 0) |
         (pos[p * 3 + 1] > this.cy[node] ? 2 : 0) |
         (pos[p * 3 + 2] > this.cz[node] ? 4 : 0);
};

Octree.prototype.finalize = function (node) {
  // post-order COM/mass accumulation for internal nodes
  if (this.child[node] === -1) return;
  let m = 0, x = 0, y = 0, z = 0;
  for (let k = 0; k < 8; k++) {
    const c = this.child[node] + k;
    this.finalize(c);
    const mc = this.m[c];
    m += mc; x += this.comx[c] * mc; y += this.comy[c] * mc;
    z += this.comz[c] * mc;
  }
  this.m[node] = m;
  if (m > 0) { this.comx[node] = x / m; this.comy[node] = y / m; this.comz[node] = z / m; }
};

Octree.prototype.force = function (pos, p, theta2, g, soft2, out) {
  const px = pos[p * 3], py = pos[p * 3 + 1], pz = pos[p * 3 + 2];
  let ax = 0, ay = 0, az = 0;
  let sp = 0;
  const stack = this.stack;
  stack[sp++] = 0;
  while (sp > 0) {
    const node = stack[--sp];
    const m = this.m[node];
    if (m === 0) continue;
    const dx = this.comx[node] - px, dy = this.comy[node] - py,
          dz = this.comz[node] - pz;
    const d2 = dx * dx + dy * dy + dz * dz;
    const leaf = this.child[node] === -1;
    const w = 2 * this.hw[node];
    if (leaf || w * w < theta2 * d2) {
      if (leaf && this.pidx[node] === p) continue;     // self
      if (d2 === 0) continue;                          // coincident stack
      const inv = 1 / Math.sqrt(d2 + soft2);
      const f = g * m * inv * inv * inv;
      ax += f * dx; ay += f * dy; az += f * dz;
    } else {
      const base = this.child[node];
      for (let k = 0; k < 8; k++) stack[sp++] = base + k;
    }
  }
  out[p * 3] = ax; out[p * 3 + 1] = ay; out[p * 3 + 2] = az;
};

// AABB records for the wireframe overlay: tight per-node boxes would need a
// second pass, so like the server path we emit the geometric cell cubes with
// depth fraction (vis/server.py boxes_blob format: lo3, hi3, depth_frac).
Octree.prototype.boxes = function (maxBoxes) {
  const recs = [];
  let maxDepth = 1;
  const walk = (node, depth) => {
    if (this.m[node] === 0 || recs.length >= maxBoxes) return;
    if (depth > maxDepth) maxDepth = depth;
    recs.push([this.cx[node] - this.hw[node], this.cy[node] - this.hw[node],
               this.cz[node] - this.hw[node], this.cx[node] + this.hw[node],
               this.cy[node] + this.hw[node], this.cz[node] + this.hw[node],
               depth]);
    if (this.child[node] !== -1)
      for (let k = 0; k < 8; k++) walk(this.child[node] + k, depth + 1);
  };
  walk(0, 0);
  const out = new Float32Array(recs.length * 7);
  for (let i = 0; i < recs.length; i++) {
    for (let k = 0; k < 6; k++) out[i * 7 + k] = recs[i][k];
    out[i * 7 + 6] = recs[i][6] / maxDepth;
  }
  return out;
};

// ---- simulation -------------------------------------------------------------
function LocalSim(opts) {
  opts = opts || {};
  this.n0 = opts.n || 4096;
  this.seed = opts.seed || 0;
  this.settings = {
    dt: opts.dt || 3e-2,
    g: 1.0,
    g_soft: opts.g_soft === undefined ? 0.02 : opts.g_soft,
    theta2: opts.theta2 === undefined ? 1.0 : opts.theta2,
  };
  this.boundsWidth = opts.bounds_width || 20.0; // CLI default: 2x scene box
  this.reset();
}

LocalSim.prototype.reset = function () {
  const s = makeDisc(this.n0, this.seed, 10.0, 0.2, 1.0);
  this.pos = s.pos; this.vel = s.vel; this.mass = s.mass; this.n = s.n;
  this.acc = new Float64Array(this.n * 3);
  this.tree = new Octree(this.n);
  this.treeStamp = -1; // step count the tree was last built for (boxesF32)
  this.elapsed = 0;
  this.steps = 0;
};

LocalSim.prototype.computeForces = function () {
  const { g, g_soft, theta2 } = this.settings;
  const soft2 = g_soft * g_soft;
  const hw = this.boundsWidth / 2;
  this.tree.build(this.pos, this.mass, this.n, [0, 0, 0], hw);
  // stamp with the post-step count (stepBy increments after forces) so the
  // 250 ms boxes poll reuses this build instead of re-inserting N nodes 4x/s
  this.treeStamp = this.steps + 1;
  for (let p = 0; p < this.n; p++)
    this.tree.force(this.pos, p, theta2, g, soft2, this.acc);
};

LocalSim.prototype.stepBy = function (dt) {
  const n = this.n, pos = this.pos, vel = this.vel;
  const h = dt / 2, hw = this.boundsWidth / 2;
  // 1. half drift
  for (let i = 0; i < n * 3; i++) pos[i] += vel[i] * h;
  // 2. open-boundary cull — literal retain() (reference src/shared.rs:95-101)
  let w = 0;
  for (let i = 0; i < n; i++) {
    const x = pos[i * 3], y = pos[i * 3 + 1], z = pos[i * 3 + 2];
    if (x >= -hw && x <= hw && y >= -hw && y <= hw && z >= -hw && z <= hw) {
      if (w !== i) {
        pos[w * 3] = x; pos[w * 3 + 1] = y; pos[w * 3 + 2] = z;
        vel[w * 3] = vel[i * 3]; vel[w * 3 + 1] = vel[i * 3 + 1];
        vel[w * 3 + 2] = vel[i * 3 + 2];
        this.mass[w] = this.mass[i];
      }
      w++;
    }
  }
  this.n = w;
  // 3. forces
  this.computeForces();
  // 4. kick + half drift
  const acc = this.acc;
  for (let i = 0; i < w * 3; i++) {
    vel[i] += acc[i] * dt;
    pos[i] += vel[i] * h;
  }
  this.elapsed += dt;
  this.steps++;
};

LocalSim.prototype.step = function () { this.stepBy(this.settings.dt); };

LocalSim.prototype.positionsF32 = function () {
  const out = new Float32Array(this.n * 3);
  for (let i = 0; i < this.n * 3; i++) out[i] = this.pos[i];
  return out;
};

LocalSim.prototype.boxesF32 = function (maxBoxes) {
  // Rebuild only when positions changed since the last build: while running,
  // every computeForces refreshes the tree (half a drift stale — invisible at
  // wireframe granularity); while paused this rebuilds once and then caches.
  if (this.treeStamp !== this.steps) {
    const hw = this.boundsWidth / 2;
    this.tree.build(this.pos, this.mass, this.n, [0, 0, 0], hw);
    this.treeStamp = this.steps;
  }
  return this.tree.boxes(maxBoxes || 20000);
};

// exact pairwise energy diagnostic (kinetic + potential), used by the tests
LocalSim.prototype.energy = function () {
  const { g, g_soft } = this.settings;
  const soft2 = g_soft * g_soft;
  let ke = 0, pe = 0;
  for (let i = 0; i < this.n; i++) {
    const vx = this.vel[i * 3], vy = this.vel[i * 3 + 1], vz = this.vel[i * 3 + 2];
    ke += 0.5 * this.mass[i] * (vx * vx + vy * vy + vz * vz);
    for (let j = i + 1; j < this.n; j++) {
      const dx = this.pos[j * 3] - this.pos[i * 3];
      const dy = this.pos[j * 3 + 1] - this.pos[i * 3 + 1];
      const dz = this.pos[j * 3 + 2] - this.pos[i * 3 + 2];
      const r = Math.sqrt(dx * dx + dy * dy + dz * dz + soft2);
      pe -= g * this.mass[i] * this.mass[j] / r;
    }
  }
  return ke + pe;
};

if (typeof window !== "undefined") {
  window.LocalSim = LocalSim;
  window.makeDisc = makeDisc;
}
