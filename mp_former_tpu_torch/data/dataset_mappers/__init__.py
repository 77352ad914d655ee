"""Dataset mappers: a record and a `RandomState` in, one training sample out;
each registers in `DATASET_MAPPER_REGISTRY` under its
`INPUT.DATASET_MAPPER_NAME` when imported here: `coco_instance_lsj`,
`coco_panoptic_lsj`, `mask_former_semantic`, `mask_former_panoptic`,
`mask_former_instance`."""

from . import coco_instance_new_baseline, coco_panoptic_new_baseline  # noqa: F401
from . import mask_former_mappers  # noqa: F401
