"""GITS: the DP search for a sampling schedule (``gits.search``)."""

from .search import (GITSConfig, compute_cost_matrix, dp_search, dp_search_multi,
                     gits_schedule)

__all__ = ["GITSConfig", "compute_cost_matrix", "dp_search", "dp_search_multi",
           "gits_schedule"]
