"""iBUG 68-landmark semantics: the flip reindex map and the named facial
region index groups (counterpart of the JAX package's `facemodel/keypoints68.py`).
Keypoints are localized to specific facial features, so a horizontal flip
must exchange left/right."""

# fmt: off
flip_map = [
    16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0,          # chin
    26, 25, 24, 23, 22, 21, 20, 19, 18, 17,                            # brows
    27, 28, 29, 30,                                                     # nose back
    35, 34, 33, 32, 31,                                                 # nose bottom
    45, 44, 43, 42, 47, 46,                                             # -> right eye
    39, 38, 37, 36, 41, 40,                                             # -> left eye
    54, 53, 52, 51, 50, 49, 48,                                         # upper lip
    59, 58, 57, 56, 55,                                                 # lower lip
    64, 63, 62, 61, 60,                                                 # upper mouth
    67, 66, 65,                                                         # lower mouth
]
# fmt: on

# Warning: both sides contain the middle points.
chin_left = [*range(0, 9)]
chin_right = [*range(8, 17)]

upperlip_left = [48, 49, 50, 51]
upperlip_right = [51, 52, 53, 54]
lowerlip_left = [48, 59, 58, 57]
lowerlip_right = [57, 56, 55, 54]
uppermouth_left = [60, 61, 62]
uppermouth_right = [62, 63, 64]
lowermouth_left = [60, 67, 66]
lowermouth_right = [66, 65, 64]

nose_left = [31, 32, 33]
nose_right = [33, 34, 35]
nose_back = [27, 28, 29, 30, 33]

eyecorners_left = [36, 39]
eyecorners_right = [42, 45]
brows_left = [*range(17, 22)]
brows_right = [*range(22, 27)]

eye_left_top = [36, 37, 38, 39]
eye_left_bottom = [36, 41, 40, 39]

eye_right_top = [42, 43, 44, 45]
eye_right_bottom = [42, 47, 46, 45]

eye_not_corners = [37, 38, 41, 40, 43, 44, 47, 46]

nose_tip = 33
mouth_corner_left = 60
mouth_corner_right = 64
