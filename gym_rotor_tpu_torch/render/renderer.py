"""Real-time 3D view of one quadrotor (the port's own copy of
``gym_rotor_tpu/render/renderer.py``; NumPy and matplotlib).

The quad body (two crossed arms, four rotors), its body axes, the heading
command and the goal with its trail, in a z-down view.  matplotlib is
imported only when a ``Renderer`` is made, so the package imports without
it.  ``interactive=False`` renders offscreen (frames through ``save``);
``capture=True`` records every frame for ``save_animation`` (an animated
GIF).
"""
from __future__ import annotations

import numpy as np

ARM = 0.23          # arm length [m] (d_nominal)
AXIS_LEN = 0.4


class Renderer:
    def __init__(self, interactive: bool = None, fps: int = 60,
                 capture: bool = False):
        import matplotlib

        if interactive is None:
            interactive = matplotlib.get_backend().lower() not in (
                "agg", "template")
        if not interactive:
            matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        self.plt = plt
        self.interactive = interactive
        self.fps = fps
        self.capture = capture
        self.frames = []
        self.fig = plt.figure(figsize=(9, 6))
        self.ax = self.fig.add_subplot(111, projection="3d")
        self.trail = []
        self.goal_trail = []

    def draw(self, x, R, xd, b1d):
        ax = self.ax
        ax.cla()
        b1, b2, b3 = R[:, 0], R[:, 1], R[:, 2]
        self.trail.append(np.asarray(x))
        self.goal_trail.append(np.asarray(xd))
        if len(self.trail) > 2000:
            self.trail = self.trail[-2000:]
            self.goal_trail = self.goal_trail[-2000:]

        # arms + rotors (reference draws body boxes along b1/b2, rotors at
        # the four arm tips, quad.py:503-521)
        for bdir, color in ((b1, "tab:orange"), (b2, "tab:cyan")):
            tip1, tip2 = x + ARM * bdir, x - ARM * bdir
            ax.plot(*zip(tip1, tip2), color="k", lw=2)
            for tip in (tip1, tip2):
                ax.scatter(*tip, color=color, s=60, alpha=0.8)

        # body axes (quad.py:554-564)
        for bdir, color in ((b1, "y"), (b2, "g"), (b3, "b")):
            ax.quiver(*x, *(AXIS_LEN * bdir), color=color, lw=1)

        # heading command b1c (projection of b1d onto the horizontal plane
        # through b3, quad.py:488)
        b1c = b1d - np.dot(b1d, b3) * b3
        ax.quiver(*x, *(AXIS_LEN * 1.2 * b1c), color="r", lw=1.5)

        # goal + trails (quad.py:538-543)
        ax.scatter(*xd, color="r", s=40, alpha=0.65)
        tr = np.asarray(self.trail)
        ax.plot(tr[:, 0], tr[:, 1], tr[:, 2], color="b", lw=0.7, alpha=0.6)
        gt = np.asarray(self.goal_trail)
        ax.plot(gt[:, 0], gt[:, 1], gt[:, 2], "r.", ms=1, alpha=0.4)

        ax.set_xlim(-1.7, 1.7)
        ax.set_ylim(-1.7, 1.7)
        ax.set_zlim(1.7, -1.7)  # z-down like the reference view
        ax.set_xlabel("x [m]")
        ax.set_ylabel("y [m]")
        ax.set_zlabel("z [m]")
        if self.interactive:
            self.plt.pause(1.0 / self.fps)
        else:
            self.fig.canvas.draw()
        if self.capture:
            self.frames.append(self._grab_frame())
        return True

    def _grab_frame(self):
        from PIL import Image

        buf = np.asarray(self.fig.canvas.buffer_rgba())
        return Image.fromarray(buf[..., :3])

    def save(self, path: str):
        self.fig.savefig(path, dpi=110)
        return path

    def save_animation(self, path: str, fps: int = None):
        """Write captured frames as an animated GIF (requires ``capture=True``
        at construction and at least one ``draw``)."""
        if not self.frames:
            raise ValueError("no frames captured; construct with capture=True"
                             " and call draw() first")
        fps = fps or min(self.fps, 30)
        self.frames[0].save(
            path, save_all=True, append_images=self.frames[1:],
            duration=int(1000 / fps), loop=0)
        return path

    def close(self):
        self.plt.close(self.fig)
