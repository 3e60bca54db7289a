"""Engine: the top-level context object (reference parity layer).

Mirrors the reference's Engine/Window/Renderer trio (engine/Engine.h:26-38,
engine/Window.h:23, renderer/Renderer.h:44-57) in headless form:

  * Engine owns the device context and asset-path resolution
    (Engine::assetPath, Engine.cpp:12-15),
  * `load_scene` is the Loader entry (Loader.h:29),
  * `run` is the Window::run + Renderer::run frame loop: progressive
    accumulation with the reference's running-mean semantics
    (raygen.rgen:84-91), one timestamp per frame, optional per-frame
    callback in place of a swapchain present,
  * profiling scopes are named after the reference's passes ("Frame",
    "rt pass", "blit pass"; SURVEY.md §5.1) so traces line up.

The Vulkan frame machinery (fences, double-buffered inflight frames,
framegraphs) has no analogue to build here: XLA pipelines the async dispatch
(`render_step` is donated + jit-compiled once, successive frames overlap
host work with device compute exactly like MAX_INFLIGHTS=2 did).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .integrator.path_tracer import render_step
from .scene import load_mitsuba_scene
from .scene.data import SceneData
from .utils.config import RenderConfig
from .utils.metrics import MetricsLogger


class Engine:
    def __init__(self, base_path: str = ".", asset_path: Optional[str] = None):
        self.base_path = base_path
        self._asset_path = asset_path or os.path.join(base_path, "scenes")
        self.scene: Optional[SceneData] = None
        self.cfg = RenderConfig()
        self.accum: Optional[jax.Array] = None
        self.timestamp = 0
        self.metrics = MetricsLogger(None)

    # Engine::assetPath (Engine.cpp:12-15)
    def asset_path(self, name: str = "") -> str:
        return os.path.join(self._asset_path, name)

    # Engine::init (Engine.cpp:37-40) — width/height instead of a window
    def init(self, width: int, height: int, **cfg_kw) -> "Engine":
        self.cfg = self.cfg.replace(width=width, height=height, **cfg_kw)
        self.reset()
        return self

    # loadScene (Loader.cpp:253)
    def load_scene(self, path: str) -> SceneData:
        self.scene, builder = load_mitsuba_scene(path)
        self.reset()
        return self.scene

    def reset(self) -> None:
        """Clear the progressive accumulation buffer."""
        self.accum = jnp.zeros((self.cfg.height, self.cfg.width, 3), jnp.float32)
        self.timestamp = 0

    # Window::run + Renderer::run (Window.cpp:20-25, Renderer.cpp:93-116)
    def run(
        self,
        frames: int,
        on_frame: Optional[Callable[[int, np.ndarray], None]] = None,
        scene: Optional[SceneData] = None,
    ) -> np.ndarray:
        """Run `frames` progressive 1-spp frames; returns the accumulated
        image as numpy.  `on_frame(i, image)` stands in for the swapchain
        present."""
        scene = scene or self.scene
        assert scene is not None, "load_scene first"
        one = self.cfg.replace(spp=1)
        for _ in range(frames):
            t0 = time.time()
            with jax.named_scope("Frame"):  # FrameMark (Renderer.cpp:94)
                self.accum = render_step(
                    scene, one, self.accum, jnp.uint32(self.timestamp)
                )
            self.timestamp += 1
            if on_frame is not None:
                on_frame(self.timestamp, np.asarray(self.accum))
            self.metrics.log(
                event="frame", timestamp=self.timestamp, seconds=time.time() - t0
            )
        return np.asarray(self.accum)

    def save(self, path: str, tonemap: bool = False) -> None:
        from .io import write_exr, write_pfm, write_png

        img = np.asarray(self.accum)
        if path.endswith(".exr"):
            write_exr(path, img)
        elif path.endswith(".pfm"):
            write_pfm(path, img)
        else:
            write_png(path, img, tonemap=tonemap)

    def checkpoint(self, path: str) -> None:
        """Persist resumable progressive state (SURVEY.md §5.4)."""
        from .io.checkpoint import save_checkpoint

        save_checkpoint(
            path,
            dict(accum=np.asarray(self.accum), timestamp=np.uint32(self.timestamp)),
        )

    def restore(self, path: str) -> None:
        from .io.checkpoint import load_checkpoint

        state = load_checkpoint(path)
        self.accum = jnp.asarray(state["accum"])
        self.timestamp = int(state["timestamp"])
