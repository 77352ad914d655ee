"""Builtin dataset class metadata (public dataset facts; d2's builtin_meta and
the reference's register_* class tables): the port's own copy of
`mp_former_tpu/data/datasets/builtin_meta.py`."""

COCO_THING_CLASSES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]

COCO_PANOPTIC_STUFF_CLASSES = [
    "banner", "blanket", "bridge", "cardboard", "counter", "curtain",
    "door-stuff", "floor-wood", "flower", "fruit", "gravel", "house", "light",
    "mirror-stuff", "net", "pillow", "platform", "playingfield", "railroad",
    "river", "road", "roof", "sand", "sea", "shelf", "snow", "stairs", "tent",
    "towel", "wall-brick", "wall-stone", "wall-tile", "wall-wood",
    "water-other", "window-blind", "window-other", "tree-merged",
    "fence-merged", "ceiling-merged", "sky-other-merged", "cabinet-merged",
    "table-merged", "floor-other-merged", "pavement-merged", "mountain-merged",
    "grass-merged", "dirt-merged", "paper-merged", "food-other-merged",
    "building-other-merged", "rock-merged", "wall-other-merged", "rug-merged",
]

CITYSCAPES_SEM_SEG_CLASSES = [
    "road", "sidewalk", "building", "wall", "fence", "pole", "traffic light",
    "traffic sign", "vegetation", "terrain", "sky", "person", "rider", "car",
    "truck", "bus", "train", "motorcycle", "bicycle",
]
CITYSCAPES_THING_CLASSES = [
    "person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle",
]

ADE20K_150_CLASSES = [
    "wall", "building", "sky", "floor", "tree", "ceiling", "road", "bed",
    "windowpane", "grass", "cabinet", "sidewalk", "person", "earth", "door",
    "table", "mountain", "plant", "curtain", "chair", "car", "water",
    "painting", "sofa", "shelf", "house", "sea", "mirror", "rug", "field",
    "armchair", "seat", "fence", "desk", "rock", "wardrobe", "lamp",
    "bathtub", "railing", "cushion", "base", "box", "column", "signboard",
    "chest of drawers", "counter", "sand", "sink", "skyscraper", "fireplace",
    "refrigerator", "grandstand", "path", "stairs", "runway", "case",
    "pool table", "pillow", "screen door", "stairway", "river", "bridge",
    "bookcase", "blind", "coffee table", "toilet", "flower", "book", "hill",
    "bench", "countertop", "stove", "palm", "kitchen island", "computer",
    "swivel chair", "boat", "bar", "arcade machine", "hovel", "bus", "towel",
    "light", "truck", "tower", "chandelier", "awning", "streetlight", "booth",
    "television receiver", "airplane", "dirt track", "apparel", "pole",
    "land", "bannister", "escalator", "ottoman", "bottle", "buffet", "poster",
    "stage", "van", "ship", "fountain", "conveyer belt", "canopy", "washer",
    "plaything", "swimming pool", "stool", "barrel", "basket", "waterfall",
    "tent", "bag", "minibike", "cradle", "oven", "ball", "food", "step",
    "tank", "trade name", "microwave", "pot", "animal", "bicycle", "lake",
    "dishwasher", "screen", "blanket", "sculpture", "hood", "sconce", "vase",
    "traffic light", "tray", "ashcan", "fan", "pier", "crt screen", "plate",
    "monitor", "bulletin board", "shower", "radiator", "glass", "clock",
    "flag",
]

# ADE20K instance/panoptic thing subset (100 thing classes by 0-based
# semantic index; standard ade20k-panoptic split)
ADE20K_THING_IDS = [
    7, 8, 10, 12, 14, 15, 18, 19, 20, 22, 23, 24, 27, 30, 31, 32, 33, 35,
    36, 37, 38, 39, 41, 42, 43, 44, 45, 47, 49, 50, 51, 53, 55, 56, 57, 58,
    62, 64, 65, 66, 67, 69, 70, 71, 72, 73, 74, 75, 76, 78, 80, 81, 82, 83,
    85, 86, 87, 88, 89, 90, 92, 93, 95, 97, 98, 102, 103, 104, 107, 108,
    110, 111, 112, 115, 116, 118, 119, 120, 121, 123, 124, 125, 126, 127,
    129, 130, 132, 133, 134, 135, 136, 137, 138, 139, 142, 143, 144, 146,
    147, 148,
]


def coco_panoptic_classes():
    """133 contiguous panoptic classes: 80 things then 53 stuff."""
    return COCO_THING_CLASSES + COCO_PANOPTIC_STUFF_CLASSES


def coco_panoptic_is_thing():
    import numpy as np

    t = np.zeros(133, bool)
    t[:80] = True
    return t
