from satnerf_tpu_torch.data.satellite import SatelliteScene
from satnerf_tpu_torch.data.scene import SceneFrame


def load_dataset(cfg, split: str):
    """Dataset factory mirroring datasets/__init__.py:5-25: returns a list
    [color_dataset]. The depth-supervision and blender datasets are not
    ported yet (ROADMAP: the DS pass, the nerf variant)."""
    if cfg.data != "sat":
        raise NotImplementedError(
            "the blender dataset is not ported yet: ROADMAP queue 1, 'the "
            "nerf variant'")
    if cfg.ds_lambda > 0 and split == "train":
        raise NotImplementedError(
            "the depth-supervision dataset is not ported yet: ROADMAP queue "
            "1, 'the DS pass'")
    return [SatelliteScene(root_dir=cfg.root_dir, img_dir=cfg.img_dir,
                           split=split, img_downscale=cfg.img_downscale,
                           cache_dir=cfg.cache_dir, verbose=True)]


__all__ = ["SatelliteScene", "SceneFrame", "load_dataset"]
