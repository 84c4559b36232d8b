"""The standard Cityscapes label table (the public benchmark's, as
cityscapesscripts/helpers/labels.py gives it; JAX package
``data/datasets/cityscapes_labels.py``). cityscapesscripts is not a
dependency, so the table is kept here. Each label: (name, id, trainId,
category, catId, hasInstances, ignoreInEval).
"""

from collections import namedtuple

Label = namedtuple(
    "Label", ["name", "id", "trainId", "category", "catId", "hasInstances", "ignoreInEval"]
)

labels = [
    Label("unlabeled", 0, 255, "void", 0, False, True),
    Label("ego vehicle", 1, 255, "void", 0, False, True),
    Label("rectification border", 2, 255, "void", 0, False, True),
    Label("out of roi", 3, 255, "void", 0, False, True),
    Label("static", 4, 255, "void", 0, False, True),
    Label("dynamic", 5, 255, "void", 0, False, True),
    Label("ground", 6, 255, "void", 0, False, True),
    Label("road", 7, 0, "flat", 1, False, False),
    Label("sidewalk", 8, 1, "flat", 1, False, False),
    Label("parking", 9, 255, "flat", 1, False, True),
    Label("rail track", 10, 255, "flat", 1, False, True),
    Label("building", 11, 2, "construction", 2, False, False),
    Label("wall", 12, 3, "construction", 2, False, False),
    Label("fence", 13, 4, "construction", 2, False, False),
    Label("guard rail", 14, 255, "construction", 2, False, True),
    Label("bridge", 15, 255, "construction", 2, False, True),
    Label("tunnel", 16, 255, "construction", 2, False, True),
    Label("pole", 17, 5, "object", 3, False, False),
    Label("polegroup", 18, 255, "object", 3, False, True),
    Label("traffic light", 19, 6, "object", 3, False, False),
    Label("traffic sign", 20, 7, "object", 3, False, False),
    Label("vegetation", 21, 8, "nature", 4, False, False),
    Label("terrain", 22, 9, "nature", 4, False, False),
    Label("sky", 23, 10, "sky", 5, False, False),
    Label("person", 24, 11, "human", 6, True, False),
    Label("rider", 25, 12, "human", 6, True, False),
    Label("car", 26, 13, "vehicle", 7, True, False),
    Label("truck", 27, 14, "vehicle", 7, True, False),
    Label("bus", 28, 15, "vehicle", 7, True, False),
    Label("caravan", 29, 255, "vehicle", 7, True, True),
    Label("trailer", 30, 255, "vehicle", 7, True, True),
    Label("train", 31, 16, "vehicle", 7, True, False),
    Label("motorcycle", 32, 17, "vehicle", 7, True, False),
    Label("bicycle", 33, 18, "vehicle", 7, True, False),
    Label("license plate", -1, -1, "vehicle", 7, False, True),
]

name2label = {l.name: l for l in labels}
id2label = {l.id: l for l in labels}
trainId2label = {l.trainId: l for l in reversed(labels)}
category2labels = {}
for l in labels:
    category2labels.setdefault(l.category, []).append(l)
