"""The Cityscapes label specification (cityscapesscripts/helpers/labels.py —
public dataset facts). Used by the cityscapes dataset registrations and by
the cityscapesscripts-protocol evaluators (evaluation/cityscapes_eval.py);
the port's own copy of `mp_former_tpu/data/datasets/cityscapes_labels.py`.

Fields per label: (name, id, trainId, category, catId, hasInstances,
ignoreInEval).
"""

from __future__ import annotations

from collections import namedtuple

Label = namedtuple(
    "Label", ["name", "id", "trainId", "category", "catId", "hasInstances",
              "ignoreInEval"])

LABELS = [
    Label("unlabeled",            0, 255, "void",         0, False, True),
    Label("ego vehicle",          1, 255, "void",         0, False, True),
    Label("rectification border", 2, 255, "void",         0, False, True),
    Label("out of roi",           3, 255, "void",         0, False, True),
    Label("static",               4, 255, "void",         0, False, True),
    Label("dynamic",              5, 255, "void",         0, False, True),
    Label("ground",               6, 255, "void",         0, False, True),
    Label("road",                 7,   0, "flat",         1, False, False),
    Label("sidewalk",             8,   1, "flat",         1, False, False),
    Label("parking",              9, 255, "flat",         1, False, True),
    Label("rail track",          10, 255, "flat",         1, False, True),
    Label("building",            11,   2, "construction", 2, False, False),
    Label("wall",                12,   3, "construction", 2, False, False),
    Label("fence",               13,   4, "construction", 2, False, False),
    Label("guard rail",          14, 255, "construction", 2, False, True),
    Label("bridge",              15, 255, "construction", 2, False, True),
    Label("tunnel",              16, 255, "construction", 2, False, True),
    Label("pole",                17,   5, "object",       3, False, False),
    Label("polegroup",           18, 255, "object",       3, False, True),
    Label("traffic light",       19,   6, "object",       3, False, False),
    Label("traffic sign",        20,   7, "object",       3, False, False),
    Label("vegetation",          21,   8, "nature",       4, False, False),
    Label("terrain",             22,   9, "nature",       4, False, False),
    Label("sky",                 23,  10, "sky",          5, False, False),
    Label("person",              24,  11, "human",        6, True,  False),
    Label("rider",               25,  12, "human",        6, True,  False),
    Label("car",                 26,  13, "vehicle",      7, True,  False),
    Label("truck",               27,  14, "vehicle",      7, True,  False),
    Label("bus",                 28,  15, "vehicle",      7, True,  False),
    Label("caravan",             29, 255, "vehicle",      7, True,  True),
    Label("trailer",             30, 255, "vehicle",      7, True,  True),
    Label("train",               31,  16, "vehicle",      7, True,  False),
    Label("motorcycle",          32,  17, "vehicle",      7, True,  False),
    Label("bicycle",             33,  18, "vehicle",      7, True,  False),
    Label("license plate",       -1,  -1, "vehicle",      7, False, True),
]

NAME_TO_LABEL = {l.name: l for l in LABELS}
ID_TO_LABEL = {l.id: l for l in LABELS}

# 19 evaluated semantic classes ordered by trainId
EVAL_LABELS = sorted(
    (l for l in LABELS if not l.ignoreInEval), key=lambda l: l.trainId)
TRAIN_ID_TO_LABEL_ID = [l.id for l in EVAL_LABELS]

# 8 thing classes for instance evaluation, ordered by trainId
INSTANCE_LABELS = [l for l in EVAL_LABELS if l.hasInstances]
# contiguous instance-class index (as used by the instance heads) -> label
INSTANCE_CONTIGUOUS_TO_LABEL = {i: l for i, l in enumerate(INSTANCE_LABELS)}
