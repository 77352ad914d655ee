"""The benchmark's plain reference of the model: plain PyTorch in float32,
a frozen copy of the port's plain-op modules with the kernels taken out
(K1 and K3 run as their plain versions, `ops/`), the matcher, the losses,
the optimizer's parameter groups and the serving post-processing. It imports
nothing of the port, and is built from the configuration file's `cfg`
block (`config.Node`), never from the port's config."""
