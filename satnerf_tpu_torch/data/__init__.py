from satnerf_tpu_torch.data.blender import BlenderScene
from satnerf_tpu_torch.data.satellite import SatelliteScene
from satnerf_tpu_torch.data.satellite_depth import SatelliteDepthScene
from satnerf_tpu_torch.data.scene import SceneFrame


def load_dataset(cfg, split: str):
    """Dataset factory mirroring datasets/__init__.py:5-25: returns a list
    [color_dataset, (depth_dataset if ds_lambda > 0 and train)]."""
    if cfg.data == "blender":
        return [BlenderScene(root_dir=cfg.root_dir, split=split)]
    if cfg.data != "sat":
        raise ValueError(f"data {cfg.data!r} is not valid")
    kw = dict(root_dir=cfg.root_dir, img_dir=cfg.img_dir, split=split,
              img_downscale=cfg.img_downscale, cache_dir=cfg.cache_dir)
    outputs = [SatelliteScene(verbose=True, **kw)]
    if cfg.ds_lambda > 0 and split == "train":
        outputs.append(SatelliteDepthScene(**kw))
    return outputs


__all__ = ["BlenderScene", "SatelliteScene", "SatelliteDepthScene",
           "SceneFrame", "load_dataset"]
