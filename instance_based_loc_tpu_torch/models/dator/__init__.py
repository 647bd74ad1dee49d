"""DATOR: the multi-modal (RGB + depth) object re-identification model, for
inference (counterpart of `instance_based_loc_tpu/models/dator/`): the
TransReID towers, FourDNet, the crop preprocessing, the flat npz checkpoint
I/O and the localisation embedder. Training is not ported yet."""
