"""Offline visualization: map renders and frame overlays.

Counterpart of the JAX package's ``viz``, on the port's ``MapState`` and
``FrameFeatures``. Replaces the reference's Pangolin / OpenGL layer
(src/Viewer.cc, src/FrameDrawer.cc, src/MapDrawer.cc) with offline
matplotlib PNGs; matplotlib is imported when a function draws, not when
this package is imported.
"""
from .plot import draw_frame, plot_map, plot_trajectories  # noqa: F401
