from fcsr_tpu_torch.iox.checkpoint import (load_arrays, load_params,
                                           load_pytree, load_state,
                                           save_arrays, save_pytree,
                                           save_state)
from fcsr_tpu_torch.iox.submission import (DEFAULT_COMPETITION,
                                           kaggle_submit, save_prediction,
                                           submission_frame)
from fcsr_tpu_torch.iox.weights import (flat_to_state, flax_to_state,
                                        gat_flat_to_state, gat_flax_to_state,
                                        gat_state_to_flat, gat_state_to_flax,
                                        gat_state_to_leaves, leaves_to_state,
                                        mlp_flat_to_state, mlp_flax_to_state,
                                        mlp_state_to_flat, mlp_state_to_flax,
                                        state_to_flat, state_to_flax,
                                        state_to_leaves,
                                        upsample_flax_to_state,
                                        upsample_state_to_flax)

__all__ = ["DEFAULT_COMPETITION", "flat_to_state", "flax_to_state",
           "gat_flat_to_state", "gat_flax_to_state", "gat_state_to_flat",
           "gat_state_to_flax", "gat_state_to_leaves",
           "kaggle_submit", "leaves_to_state", "load_arrays", "load_params",
           "mlp_flat_to_state", "mlp_flax_to_state", "mlp_state_to_flat",
           "mlp_state_to_flax",
           "load_pytree", "load_state", "save_arrays", "save_prediction",
           "save_pytree", "save_state", "state_to_flat", "state_to_flax",
           "state_to_leaves", "submission_frame", "upsample_flax_to_state",
           "upsample_state_to_flax"]
