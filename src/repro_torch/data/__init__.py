from repro_torch.data.pipeline import (PoissonSampler, SyntheticLM,
                                      make_lm_batch, pack_documents)

__all__ = ["PoissonSampler", "SyntheticLM", "make_lm_batch",
           "pack_documents"]
