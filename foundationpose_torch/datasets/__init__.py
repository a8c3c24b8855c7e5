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
