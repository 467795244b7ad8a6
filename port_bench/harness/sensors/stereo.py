"""Stereo: a rectified pair of gray images, the right camera `Camera.bf /
Camera.fx` metres along the left one's x axis.

The program takes a frame as `track_stereo(left, right, det)`; K1's one
launch covers the left pyramid, then the right one (2 x 8 levels fill one
launch; a configuration with more levels gets one launch per image, which
`k1_mismatch` counts against it); the shape step reads the program's
keypoint depth image (`keypoint_depth_image`, which
`SlamSystem._reconstruct_shapes` calls for a stereo keyframe), captured
as the program made it.  The left camera's true depth stays beside the
frame for the comparison and is not fed to the program."""

CALL = "track_stereo"
K1_IMAGES = (0, 1)


def capture():
    from qsp_slam_tpu_torch.slam.shape_mapping import keypoint_depth_image

    return keypoint_depth_image


def shape_depth(frame, captured):
    return captured


def render(view, T_cw, cam):
    left, depth, instance = view(T_cw)
    T_right = T_cw.clone()
    T_right[0, 3] -= cam.baseline  # x_right = x_left - baseline
    return left, view(T_right)[0], depth, instance
