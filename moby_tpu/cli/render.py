"""`moby-render` / `moby-view` equivalent: headless trajectory visualization.

The reference renders through OpenSceneGraph; in this headless batched framework
a trajectory (`moby-regress` format `.dat`) plus its scene render to a fully
self-contained HTML file: an embedded-JSON canvas animation (orthographic
side/top views, body outlines from their collision geometry), no external
assets.

Usage:
  python -m moby_tpu.cli.render [--cpu] scene.xml traj.dat out.html
  python -m moby_tpu.cli.render [--cpu] --movie FRAMEDIR [--fps N] scene.xml traj.dat
    writes numbered PNG frames (the reference `moby-render`'s image-sequence
    mode, programs/render.cpp) via matplotlib's headless Agg backend
"""

from __future__ import annotations

import json
import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    use_cpu = "--cpu" in argv
    movie_dir = None
    fps = 30
    if "--movie" in argv:
        i = argv.index("--movie")
        movie_dir = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if "--fps" in argv:
        i = argv.index("--fps")
        fps = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    pos = [a for a in argv if not a.startswith("-")]
    if len(pos) < (2 if movie_dir else 3):
        print(__doc__)
        return 1
    xml_path, traj_path = pos[:2]
    out_path = pos[2] if len(pos) > 2 else None

    if use_cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    import numpy as np

    from ..io import mobyxml

    scene, st, _ = mobyxml.load(xml_path)

    # body metadata: enabled bodies in sorted-id order (regress convention)
    order = sorted(
        (i for i in range(scene.nb) if bool(scene.enabled[i])),
        key=lambda i: scene.body_names[i],
    )
    geoms = []
    gslot = np.asarray(scene.geom_slot)
    gparams = np.asarray(scene.geom_params)
    for k, b in enumerate(order):
        for g in range(scene.ng):
            if gslot[g] == b:
                geoms.append({"body": k, "params": gparams[g].tolist()})

    rows = []
    with open(traj_path) as f:
        for line in f:
            v = line.split()
            if len(v) >= 1 + 7 * len(order):
                rows.append([float(x) for x in v[: 1 + 7 * len(order)]])
    traj = np.array(rows)
    # decimate for file size
    stride = max(1, len(traj) // 2000)
    traj = traj[::stride]

    if movie_dir is not None:
        return _render_movie(scene, order, traj, movie_dir, fps)

    data = {
        "names": [scene.body_names[i] for i in order],
        "geoms": geoms,
        "frames": traj.tolist(),
        "nbody": len(order),
    }

    html = _TEMPLATE.replace("__DATA__", json.dumps(data))
    with open(out_path, "w") as f:
        f.write(html)
    print(f"wrote {out_path}: {len(traj)} frames, {len(order)} bodies")
    return 0


def _render_movie(scene, order, traj, out_dir, fps):
    """PNG frame sequence (the reference moby-render's per-iteration image
    dump, programs/render.cpp) using matplotlib 3D wireframes."""
    import os

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    os.makedirs(out_dir, exist_ok=True)

    gslot = np.asarray(scene.geom_slot)
    # geometry wireframes in local frame: (segments list per geom)
    gverts = np.asarray(scene.geom_verts)
    gnverts = np.asarray(scene.geom_nverts)
    gparams = np.asarray(scene.geom_params)
    gpos = np.asarray(scene.geom_pos)

    def body_wire(b):
        segs = []
        for g in range(scene.ng):
            if gslot[g] != b:
                continue
            nv = int(gnverts[g])
            if nv >= 2:
                v = gverts[g, :nv] + gpos[g]
                # connect each vertex to its 3 nearest neighbours
                d = np.linalg.norm(v[:, None] - v[None, :], axis=-1)
                for i in range(nv):
                    for j in np.argsort(d[i])[1:4]:
                        segs.append((v[i], v[j]))
            elif gparams[g, 0] > 0:
                # sphere-ish: 3 great circles of radius params[0]
                r = gparams[g, 0]
                t = np.linspace(0, 2 * np.pi, 24)
                for axes in ((0, 1), (0, 2), (1, 2)):
                    c = np.zeros((24, 3))
                    c[:, axes[0]] = r * np.cos(t)
                    c[:, axes[1]] = r * np.sin(t)
                    c += gpos[g]
                    segs += list(zip(c[:-1], c[1:]))
        return segs

    wires = {b: body_wire(b) for b in order}

    def quat_R(q):
        x, y, z, w = q
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])

    lo = traj[:, 1:].reshape(len(traj), -1, 7)[:, :, :3].min(axis=(0, 1)) - 1
    hi = traj[:, 1:].reshape(len(traj), -1, 7)[:, :, :3].max(axis=(0, 1)) + 1

    stride = max(1, len(traj) // 600)
    frames = traj[::stride]
    colors = plt.cm.tab10(np.linspace(0, 1, max(len(order), 2)))
    for fi, fr in enumerate(frames):
        fig = plt.figure(figsize=(6.4, 4.8), dpi=100)
        ax = fig.add_subplot(projection="3d")
        for k, b in enumerate(order):
            p = fr[1 + 7 * k : 4 + 7 * k]
            q = fr[4 + 7 * k : 8 + 7 * k]
            R = quat_R(q)
            for a, bb in wires[b]:
                pa = p + R @ a
                pb = p + R @ bb
                ax.plot([pa[0], pb[0]], [pa[1], pb[1]], [pa[2], pb[2]],
                        color=colors[k % len(colors)], lw=0.8)
        ax.set_xlim(lo[0], hi[0]); ax.set_ylim(lo[1], hi[1])
        ax.set_zlim(lo[2], hi[2])
        ax.set_title(f"t = {fr[0]:.3f} s")
        fig.savefig(os.path.join(out_dir, f"frame{fi:05d}.png"))
        plt.close(fig)
    print(f"wrote {len(frames)} frames to {out_dir} (fps hint {fps})")
    return 0


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>moby_tpu trajectory</title>
<style>body{font-family:monospace;background:#111;color:#ccc;margin:16px}
canvas{background:#1b1b22;border:1px solid #333}</style></head><body>
<h3>moby_tpu trajectory viewer</h3>
<div id="hud"></div>
<canvas id="cv" width="900" height="500"></canvas>
<input id="slider" type="range" min="0" max="100" value="0" style="width:900px">
<script>
const D = __DATA__;
const cv = document.getElementById('cv'), cx = cv.getContext('2d');
const hud = document.getElementById('hud');
const slider = document.getElementById('slider');
slider.max = D.frames.length - 1;
// world bounds from the trajectory
let mins=[1e9,1e9,1e9], maxs=[-1e9,-1e9,-1e9];
for (const fr of D.frames) for (let b=0;b<D.nbody;b++)
  for (let a=0;a<3;a++){const v=fr[1+7*b+a];
    mins[a]=Math.min(mins[a],v); maxs[a]=Math.max(maxs[a],v);}
const pad=1.5, w=900, h=500;
const span=Math.max(maxs[0]-mins[0], maxs[1]-mins[1], maxs[2]-mins[2], 1)+2*pad;
const scale=Math.min(w,h)/span;
// choose the vertical axis as the one with most gravity-ish variation: use
// whichever of y/z spans more across geometry radii
const vert = (maxs[2]-mins[2] > maxs[1]-mins[1]) ? 2 : 1;
const horiz = 0;
function draw(i){
  const fr=D.frames[i];
  cx.clearRect(0,0,w,h);
  cx.strokeStyle='#555';
  cx.beginPath();
  const gy=h-40-(0-(mins[vert]-pad))*scale;
  cx.moveTo(0,gy);cx.lineTo(w,gy);cx.stroke();
  for(let b=0;b<D.nbody;b++){
    const x=fr[1+7*b+horiz], v=fr[1+7*b+vert];
    const px=40+(x-(mins[horiz]-pad))*scale, py=h-40-(v-(mins[vert]-pad))*scale;
    let r=0.2*scale;
    for(const g of D.geoms) if(g.body==b && g.params[0]>0) r=g.params[0]*scale;
    cx.strokeStyle=['#7fb2ff','#ffb27f','#a8ff7f','#ff7fe3','#fffb7f'][b%5];
    cx.beginPath(); cx.arc(px,py,Math.max(r,3),0,6.283); cx.stroke();
    cx.fillStyle=cx.strokeStyle; cx.fillText(D.names[b],px+4,py-4);
  }
  hud.textContent = 't = '+fr[0].toFixed(3)+' s   (frame '+i+'/'+(D.frames.length-1)+')';
}
let playing=true, idx=0;
slider.oninput=()=>{playing=false; idx=+slider.value; draw(idx);};
cv.onclick=()=>{playing=!playing;};
setInterval(()=>{if(playing){idx=(idx+1)%D.frames.length;slider.value=idx;draw(idx);}},30);
draw(0);
</script>
<p>click canvas to pause/resume; drag slider to scrub</p>
</body></html>
"""


if __name__ == "__main__":
    sys.exit(main())
