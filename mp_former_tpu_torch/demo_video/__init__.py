"""The video demo (`demo_video/` of the JAX package): `visualizer.py`
(TrackVisualizer) and the command line, `python -m
mp_former_tpu_torch.demo_video.demo`."""
