"""Video instance segmentation (`mp_former_tpu/video/`): the YouTube-VIS
records, registrations, clip mappers and loader (`ytvis.py`), the tube
matcher and losses (`criterion.py`), the tube evaluator (`ytvis_eval.py`)
and whole-clip inference (`eval_loop.py`). The model,
`VideoMaskFormer` with its temporal decoder, is registered with the other
models (`models/meta_arch/video_maskformer.py`,
`models/transformer_decoder/video_decoder.py`)."""
