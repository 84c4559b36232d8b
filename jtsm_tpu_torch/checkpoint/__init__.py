from .convert import load_gate_ckpt, random_state_dict, variables_to_state_dict

__all__ = ["load_gate_ckpt", "random_state_dict", "variables_to_state_dict"]
