"""CMF triage: column profiles and systematics detection
(reference: triage/cmf_profile.py, triage/COVID/*)."""

from .profile import (ANG_NCOLS, column_stats, flag_systematics, plot_stats,
                      profile_files, summarize_cmf, systematics_count)

__all__ = ["column_stats", "summarize_cmf", "systematics_count",
           "flag_systematics", "profile_files", "plot_stats", "ANG_NCOLS"]
