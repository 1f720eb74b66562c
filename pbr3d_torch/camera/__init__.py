"""Stage 2, perspective camera estimation: minaret keypoints, the bounded LM
keypoint fit and the mask-IoU camera search."""
