"""Visualization — matplotlib-first, plotly-gated, as in ``pbr3d.utils.viz``.

Covers the reference's viewers (utils/visualization.py:5-55, the overlay
modes of utils/camera_estimation.py:346-477, utils/projection_utils.py:26-66,
utils/eval_helpers_intra.py:89-260).  All functions are headless: they RETURN
matplotlib figures (Agg backend), never call ``plt.show()``.  ``matplotlib``
and ``plotly`` are imported inside the functions, so the module imports
where neither is installed.  The projections, z-buffers and dilations run on
``device`` through the port's own modules at exact shapes; the images are
composed on the host.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np

from pbr3d_torch import config
from pbr3d_torch.config import labels_to_rgb


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_voxel(points: np.ndarray, colors: np.ndarray, title: str = "",
               max_points: int = 50000, seed: int = 0):
    """3D scatter of colored voxel points (reference plot_voxel,
    visualization.py:38-55)."""
    plt = _pyplot()
    if len(points) > max_points:
        sel = np.random.default_rng(seed).choice(len(points), max_points, replace=False)
        points, colors = points[sel], colors[sel]
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(projection="3d")
    c = np.asarray(colors, np.float64)
    if c.max() > 1:
        c = c / 255.0
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], c=c, s=1)
    ax.set_title(title)
    ax.set_box_aspect(np.ptp(points, axis=0) + 1e-6)
    return fig


def plot_voxel_grid(grid_labels: np.ndarray, stride: int = 2, title: str = "", *, device):
    from pbr3d_torch.carving.voxel import grid_to_points

    pts, labels, _ = grid_to_points(grid_labels, stride, device=device)
    return plot_voxel(pts.cpu().numpy(), labels_to_rgb(labels.cpu().numpy()), title)


def visualize_mesh_plotly(verts, faces, vertex_colors, title: str = ""):
    """Interactive mesh viewer (reference visualization.py:11-36); requires
    plotly."""
    try:
        import plotly.graph_objects as go
    except ImportError as e:
        raise ImportError(
            "plotly is not installed in this environment; use "
            "save_mesh_matplotlib or export the mesh instead"
        ) from e
    fig = go.Figure(
        data=[go.Mesh3d(
            x=verts[:, 0], y=verts[:, 1], z=verts[:, 2],
            i=faces[:, 0], j=faces[:, 1], k=faces[:, 2],
            vertexcolor=vertex_colors, opacity=1.0,
        )]
    )
    fig.update_layout(title=title, scene_aspectmode="data")
    return fig


def visualize_mesh_matplotlib(verts, faces, vertex_colors, title: str = ""):
    """Static fallback mesh render (Poly3DCollection)."""
    plt = _pyplot()
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(projection="3d")
    tri = verts[faces]
    face_colors = np.asarray(vertex_colors)[faces].mean(axis=1)
    coll = Poly3DCollection(tri, facecolors=face_colors, linewidths=0)
    ax.add_collection3d(coll)
    lo, hi = verts.min(0), verts.max(0)
    ax.set_xlim(lo[0], hi[0]); ax.set_ylim(lo[1], hi[1]); ax.set_zlim(lo[2], hi[2])
    ax.set_box_aspect(hi - lo + 1e-6)
    ax.set_title(title)
    return fig


def _iou(a, b):
    u = np.logical_or(a, b).sum()
    return float(np.logical_and(a, b).sum() / u) if u else 0.0


def _outline(base, gt, pr, *, device):
    """Paint the one-pixel ring around ``gt & pr`` (cross dilation) yellow."""
    from pbr3d_torch.ops.morphology import binary_dilation

    both = np.logical_and(gt, pr)
    outline = binary_dilation(both, device=device).cpu().numpy() & ~both
    base[outline] = [255, 255, 0]
    return base


def visualize_voxel_projection_iou(
    grid_labels: np.ndarray,
    part_names: Sequence[str],
    mask_labels: np.ndarray,
    cam: Dict,
    mode: str = "part_on_whole",
    *,
    device,
):
    """The reference's projection-vs-GT overlay modes
    (camera_estimation.py:346-477) in the label domain.

    Returns a list of (figure, title) pairs.  The reference's
    'part_on_part' mode is implemented WITHOUT its NameError bug
    (reference :414 references undefined variables).
    """
    from pbr3d_torch.carving.voxel import points_by_parts
    from pbr3d_torch.ops.projection import splat_labels

    plt = _pyplot()
    H, W = mask_labels.shape[:2]
    gt_rgb = labels_to_rgb(mask_labels)
    figs = []
    combined_gt = np.zeros((H, W), bool)
    combined_pr = np.zeros((H, W), bool)
    combined_proj = np.zeros((H, W, 3), np.float32)

    for part in part_names:
        pid = config.PART_IDS[part]
        pts, labels = points_by_parts(grid_labels, [part], device=device)
        if len(pts) == 0:
            continue
        proj = splat_labels(
            pts, labels, None,
            cam["cam_pos"], cam["target"], cam["f"], cam["cx"], cam["cy"], H, W,
        ).cpu().numpy()
        gt = mask_labels == pid
        pr = proj == pid
        combined_gt |= gt
        combined_pr |= pr
        combined_proj += labels_to_rgb(proj).astype(np.float32)

        if mode in ("part_on_whole", "part_on_part"):
            proj_rgb = labels_to_rgb(proj)
            if mode == "part_on_whole":
                vis = (0.7 * proj_rgb + 0.3 * gt_rgb).astype(np.uint8)
            else:
                vis = np.zeros_like(gt_rgb)
                vis[gt] = gt_rgb[gt]
                vis[pr] = proj_rgb[pr]
                overlap = gt & pr
                blended = np.clip((0.7 * proj_rgb + 0.3 * gt_rgb) * 1.5, 0, 255)
                vis[overlap] = blended[overlap].astype(np.uint8)
            vis = _outline(vis, gt, pr, device=device)
            fig = plt.figure(figsize=(6, 6))
            plt.imshow(vis)
            plt.title(f"{part} | IoU: {_iou(gt, pr):.3f}")
            plt.axis("off")
            figs.append((fig, part))

    if mode == "whole_on_whole":
        combined_gt = mask_labels != config.BACKGROUND_ID
        vis = np.zeros((H, W, 3), np.uint8)
        vis[combined_gt & ~combined_pr] = [0, 255, 0]
        vis[combined_pr & ~combined_gt] = [255, 0, 0]
        vis[combined_gt & combined_pr] = [255, 255, 0]
        fig = plt.figure(figsize=(6, 6))
        plt.imshow(vis)
        plt.title(f"Combined Binary | IoU: {_iou(combined_gt, combined_pr):.3f}")
        plt.axis("off")
        figs.append((fig, "combined_binary"))

    if mode == "whole_on_whole_color":
        proj_img = np.clip(combined_proj, 0, 255).astype(np.uint8)
        vis = (0.7 * proj_img + 0.3 * gt_rgb).astype(np.uint8)
        fig = plt.figure(figsize=(6, 6))
        plt.imshow(vis)
        plt.title("Combined Color Projection Overlay")
        plt.axis("off")
        figs.append((fig, "combined_color"))

    return figs


def visualize_reprojection(
    mask_labels: np.ndarray,
    voxel_kps: Mapping[str, np.ndarray],
    image_kps: Mapping[str, tuple],
    cam: Dict,
    title: str = "Reprojection",
    *,
    device,
):
    """GT-vs-projected keypoint overlay + error table
    (reference projection_utils.py:26-66).  Returns (figure, {name: error})."""
    from pbr3d_torch.eval.intra import project_keypoints

    plt = _pyplot()
    proj = project_keypoints(dict(voxel_kps), cam, device=device)
    fig = plt.figure(figsize=(8, 8))
    plt.imshow(labels_to_rgb(mask_labels))
    errors = {}
    for name, gt in image_kps.items():
        pr = proj[name]
        plt.plot(gt[0], gt[1], "go")
        plt.plot(pr[0], pr[1], "ro")
        errors[name] = float(np.linalg.norm(np.asarray(gt) - pr))
    plt.title(f"{title} | avg err {np.mean(list(errors.values())):.2f}px")
    plt.axis("off")
    return fig, errors


def visualize_minaret_kp(
    monument: str,
    tag: str,
    cam: Dict,
    mask_labels: np.ndarray,
    voxel_kps: Mapping[str, np.ndarray],
    image_kps: Mapping[str, tuple],
    minarets: Sequence[str] = ("LM1", "RM1", "LM2", "RM2"),
    back_top_only: bool = False,
    *,
    device,
):
    """GT/projected minaret anchors with error segments
    (reference: eval_helpers_intra.py:89-127)."""
    from pbr3d_torch.eval.intra import project_keypoints

    plt = _pyplot()
    proj = project_keypoints(dict(voxel_kps), cam, device=device)
    fig = plt.figure(figsize=(6, 6))
    plt.imshow(labels_to_rgb(mask_labels))
    plt.title(f"{monument} | {tag} | Minaret KP reprojection")
    plt.axis("off")
    for m in minarets:
        names = [f"{m}_top"]
        if not (m in ("LM2", "RM2") and back_top_only):
            names.append(f"{m}_bottom")
        for k in names:
            if k not in image_kps:
                continue
            gt, pr = image_kps[k], proj[k]
            plt.scatter(gt[0], gt[1], c="lime", s=25)
            plt.scatter(pr[0], pr[1], c="red", s=25)
            plt.plot([gt[0], pr[0]], [gt[1], pr[1]], color="yellow", linewidth=1)
    return fig


def visualize_minarets_all_cams(
    grid_labels: np.ndarray,
    mask_labels: np.ndarray,
    cams: Mapping[str, Dict],
    *,
    device,
):
    """Visibility-aware minaret overlay per camera tag
    (reference: eval_helpers_intra.py:226-262).  Returns (figure, {tag: IoU})."""
    from pbr3d_torch.carving.voxel import points_by_parts
    from pbr3d_torch.eval.intra import _iou_bool, _visible, _zbuf

    plt = _pyplot()
    H, W = mask_labels.shape[:2]
    gt = np.isin(mask_labels, config.part_ids(["front_minarets", "back_minarets"]))
    pts, _ = points_by_parts(grid_labels, ["front_minarets", "back_minarets"], device=device)

    fig = plt.figure(figsize=(6 * len(cams), 5))
    ious = {}
    for i, (tag, cam) in enumerate(cams.items(), 1):
        zb = _zbuf(grid_labels, cam, H, W, device)
        pr = _visible(pts, cam, zb, device).cpu().numpy()
        ious[tag] = _iou_bool(gt, pr, device)
        img = np.zeros((H, W, 3), np.uint8)
        img[gt] = [0, 255, 0]
        img[pr] = [255, 0, 0]
        img[gt & pr] = [255, 255, 0]
        ax = fig.add_subplot(1, len(cams), i)
        ax.imshow(img)
        ax.set_title(f"minarets | {tag} | IoU={ious[tag]:.3f}")
        ax.axis("off")
    fig.tight_layout()
    return fig, ious


def visualize_side_by_side(gt, pr_init, pr_final, title, iou0, iou1):
    """Green/red/yellow init-vs-final comparison
    (reference eval_helpers_intra.py:197-219)."""
    plt = _pyplot()
    fig = plt.figure(figsize=(12, 5))
    for i, (pr, iou, tag) in enumerate(((pr_init, iou0, "init"), (pr_final, iou1, "final")), 1):
        vis = np.zeros((*gt.shape, 3), np.uint8)
        vis[gt] = [0, 255, 0]
        vis[pr] = [255, 0, 0]
        vis[gt & pr] = [255, 255, 0]
        ax = fig.add_subplot(1, 2, i)
        ax.imshow(vis)
        ax.set_title(f"{title} | {tag} | IoU={iou:.3f}")
        ax.axis("off")
    fig.tight_layout()
    return fig
