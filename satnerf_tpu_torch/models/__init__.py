from satnerf_tpu_torch.models.nerf import (RadianceField, TransientEmbedding,
                                          build_model)

__all__ = ["RadianceField", "TransientEmbedding", "build_model"]
