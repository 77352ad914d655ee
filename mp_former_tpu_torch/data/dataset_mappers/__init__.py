"""Dataset mappers: a record and a `RandomState` in, one training sample out;
each registers in `DATASET_MAPPER_REGISTRY` under its
`INPUT.DATASET_MAPPER_NAME` when imported here."""

from . import coco_instance_new_baseline  # noqa: F401
