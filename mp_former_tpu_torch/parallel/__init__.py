"""Data parallelism across processes (`mp_former_tpu/parallel/`): `dist`
launches the processes and holds the collectives, `mesh` reads the config's
data-parallel size, `rows` keeps a distributed step's random draws equal to
the one-process step's."""
