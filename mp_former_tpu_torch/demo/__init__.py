"""The image demo (`demo/` of the JAX package): `predictor.py` (Predictor,
AsyncPredictor, VisualizationDemo), `overlay.py` (the drawings and the
image writer) and the command line, `python -m mp_former_tpu_torch.demo.demo`."""
