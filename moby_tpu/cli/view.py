"""`moby-view` equivalent: simulate a scene and open the animated viewer.

The reference's view binary (programs/view.cpp) opens an interactive
OpenSceneGraph window on a trajectory. Headless analog: run the scene,
render the self-contained HTML animation (`cli.render`), and open it in the
default browser (skipped with --no-open or when no display/browser exists —
the file path is always printed).

Usage:
  python -m moby_tpu.cli.view [-s=DT] [-mt=T] [--cpu] [--no-open] scene.xml [out.html]
"""

from __future__ import annotations

import os
import sys
import tempfile


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    step_size = None
    max_time = 2.0
    no_open = "--no-open" in argv
    use_cpu = "--cpu" in argv
    pos = []
    for a in argv:
        if a.startswith("-s="):
            step_size = float(a[3:])
        elif a.startswith("-mt="):
            max_time = float(a[4:])
        elif a.startswith("-"):
            continue
        else:
            pos.append(a)
    if not pos:
        print(__doc__)
        return 1
    xml_path = pos[0]
    out_html = pos[1] if len(pos) > 1 else os.path.join(
        tempfile.gettempdir(),
        os.path.splitext(os.path.basename(xml_path))[0] + ".html",
    )

    from . import regress, render

    with tempfile.NamedTemporaryFile(
        mode="w", suffix=".dat", delete=False
    ) as tf:
        traj_path = tf.name
    args = [f"-mt={max_time}"]
    if step_size is not None:
        args.append(f"-s={step_size}")
    if use_cpu:
        args.append("--cpu")
    rc = regress.main(args + [xml_path, traj_path])
    if rc:
        return rc
    rc = render.main(
        (["--cpu"] if use_cpu else []) + [xml_path, traj_path, out_html]
    )
    if rc:
        return rc
    print(f"viewer: {out_html}")
    if not no_open:
        import webbrowser

        try:
            webbrowser.open("file://" + os.path.abspath(out_html))
        except Exception:
            pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
