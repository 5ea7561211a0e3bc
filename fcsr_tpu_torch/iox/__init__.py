from fcsr_tpu_torch.iox.weights import (flat_to_state, flax_to_state,
                                        leaves_to_state, state_to_flat,
                                        state_to_flax, state_to_leaves)

__all__ = ["flat_to_state", "flax_to_state", "leaves_to_state",
           "state_to_flat", "state_to_flax", "state_to_leaves"]
