"""RGB-D: one camera's gray image and depth image (metres).

The program takes a frame as `track_rgbd(gray, depth, det)`; K1's launch
covers the gray image's pyramid; the shape step reads the frame's depth
image, which is also the truth."""

CALL = "track_rgbd"
K1_IMAGES = (0,)


def capture():
    return None


def shape_depth(frame, captured):
    return frame[1]


def render(view, T_cw, cam):
    gray, depth, instance = view(T_cw)
    return gray, depth, depth, instance
