from .readers import (
    YcbineoatReader,
    BopBaseReader,
    LinemodOcclusionReader,
    LinemodReader,
    YcbVideoReader,
    TlessReader,
    HomebrewedReader,
    ItoddReader,
    IcbinReader,
    TudlReader,
    get_bop_reader,
    get_bop_video_dirs,
)
from .synthetic import (
    sample_pose_pairs,
    delta_targets,
    make_refiner_batch,
    make_scorer_batch,
)
from .h5_pairs import (
    PairH5Dataset,
    PoseRefinePairH5Dataset,
    TripletH5Dataset,
    ScoreMultiPairH5Dataset,
)
