"""The MoE kind at the tests' tiny sizes."""

SIZES = {"hidden_size": 128, "intermediate_size": 64, "num_attention_heads": 2, "head_dim": 64,
         "num_hidden_layers": 2, "vocab_size": 256, "num_key_value_heads": 1,
         "num_local_experts": 4}
#: limits at the tiny sizes, set from CPU readings as the dense kind's are
#: (the control's router in int8 too). Sound / control / half batch: loss
#: 6.7e-5 / 8.3e-5 / 3.0e-3, grad1 1.5e-2 / 7.0e-2 / 0.41, change 1.5e-3 /
#: 2.0e-2 / 0.22
LIMITS = {"bf16": {"loss_gap": 1e-3, "grad1_gap": 0.04, "change_gap": 8e-3}}
