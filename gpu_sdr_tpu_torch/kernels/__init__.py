"""Build and load the package's CUDA kernels (see build.py)."""


def wrappers() -> dict:
    """Each kernel wrapper of the package, by its name in the smoke's
    kernels line; each counts its kernel's launches in ``launches``."""
    from ..ops.chain import chain
    from ..ops.channelizer import (channelizer, channelizer_at,
                                   channelizer_at_halo,
                                   channelizer_scrambled)
    from ..ops.ddc import ddc_fused
    from ..ops.fold import fold, fold_rotg, fold_streamed, fold_t
    from ..ops.lockin_at import fused_chirp_lockin, lockin_at
    from ..ops.lockin_table import lockin_self, lockin_table
    from ..ops.presum import presum, presum_at
    from ..ops.replay_ddc import ReplayDDC, ReplayDDCT, ShardedReplayDDC
    return {"channelizer": channelizer, "presum": presum, "ddc": ddc_fused,
            "replay_ddc": ReplayDDC, "replay_ddc_t": ReplayDDCT,
            "fold": fold, "lockin_self": lockin_self,
            "lockin_table": lockin_table, "channelizer_at": channelizer_at,
            "presum_at": presum_at, "lockin_at": lockin_at,
            "channelizer_at_halo": channelizer_at_halo,
            "replay_ddc_sharded": ShardedReplayDDC, "chain": chain,
            "fold_streamed": fold_streamed, "fold_rotg": fold_rotg,
            "fold_t": fold_t, "channelizer_scrambled": channelizer_scrambled,
            "chirp_lockin": fused_chirp_lockin}


def launch_counts() -> dict:
    """{name: launches} of every kernel wrapper (wrappers())."""
    return {k: w.launches for k, w in wrappers().items()}


def reset_launch_counts() -> None:
    for w in wrappers().values():
        w.launches = 0
