"""Observability: streaming histograms (the part the server reads; the
tracing, metrics and calibration planes are not ported yet)."""
from repro_torch.obs.hist import (LogHistogram, Reservoir, hist_dict_quantile,
                                  merge_hist_dicts)

__all__ = ["LogHistogram", "Reservoir", "merge_hist_dicts",
           "hist_dict_quantile"]
