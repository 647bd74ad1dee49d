"""Trial CLIs (counterparts of `instance_based_loc_tpu/cli/`): the
localisation trial over the five dataset conventions, and the synthetic
end-to-end demo. Same flags as the JAX package's, plus `--device`."""
