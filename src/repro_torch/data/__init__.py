from repro_torch.data.pipeline import (ByteCorpus, PoissonSampler,
                                      SyntheticClassification, SyntheticLM,
                                      make_lm_batch, pack_documents)

__all__ = ["ByteCorpus", "PoissonSampler", "SyntheticClassification",
           "SyntheticLM", "make_lm_batch", "pack_documents"]
