"""psnr_views: mean PSNR over every training view of the state at the end
of set-up (step 600, after its refine boundary), rendered by the reference
renderer against the ground truth (dB): the quality the program's first 600
steps reach. Read only in runs without a trace."""


def read(raw: dict):
    return raw.get("psnr_views")
