"""Dataset class maps (ADE20K / VOC) used by the dynamic-object filter
(copy of ``cdvslam_tpu.models.datamaps``).

ADE20K_INDEX_FILT lists the 0-based indices (into the 150-class ADE20K
label set) of classes treated as dynamic/unreliable for SLAM -- sky,
people, vehicles, water bodies, animals, signboards (reference:
DINO_modules/datamaps.py:314-334; indices are public ADE20K metadata).
The reference stores them 1-based and subtracts 1 at load (slam.py:140);
here they are already 0-based.
"""

ADE20K_INDEX_FILT = [3, 13, 21, 22, 27, 44, 61, 81, 84, 91, 103, 104,
                     110, 114, 117, 127, 128, 129]

VOC2012_INDEX_FILT = [0]


# human-readable names of the filtered dynamic classes, same order as the
# reference's ADE20K_CLASS_FILT (DINO_modules/datamaps.py:314-333)
ADE20K_CLASS_FILT = [
    "sky", "person", "car", "water", "sea", "signboard", "river", "bus",
    "truck", "airplane", "van", "ship", "swimming pool", "waterfall",
    "minibike", "animal", "bicycle", "lake",
]


def seg_colormap(n=150):
    """Deterministic distinct RGB palette for seg-class visualization
    (functional replacement for the reference's vendored 150/21-entry
    color tables, DINO_modules/datamaps.py:6-313): class 0 black, then
    golden-ratio hue stepping at alternating saturation/value."""
    import colorsys

    out = [(0, 0, 0)]
    for i in range(1, n):
        h = (i * 0.61803398875) % 1.0
        s = (0.95, 0.65)[i % 2]
        v = (0.95, 0.75)[(i // 2) % 2]
        r, g, b = colorsys.hsv_to_rgb(h, s, v)
        out.append((int(r * 255), int(g * 255), int(b * 255)))
    return out
