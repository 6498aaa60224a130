"""The latent-attention MoE kind at the tests' tiny sizes: the published
192/128 head widths (the flash pair), a 32-wide latent, one dense layer and
two expert layers holding 4 of 16 experts."""

SIZES = {"hidden_size": 128, "intermediate_size": 128, "moe_intermediate_size": 32,
         "num_attention_heads": 2, "kv_lora_rank": 32, "num_hidden_layers": 3,
         "vocab_size": 256, "n_routed_experts": 4, "experts_held": [4, 4],
         "published": {"n_routed_experts": 16, "vocab_size": 163840}}
#: limits at the tiny sizes, set from CPU readings as the other kinds' are
#: (the control's router in int8 too): seeds 1-12 sound, 1-4 control, half
#: batch and unchanged. Sound / control / half batch / unchanged: loss 1.4e-3 /
#: 8.3e-4 / 8.9e-3 / 5.2e-4, grad1 2.0e-2 (the router's leaves: near-tied
#: routes flip between bf16 and float32) / 2.7e-2 / 0.43 / 1.0, change 9.3e-3
#: / 8.6e-3 / 0.21 / 1.0; the control fails by grad1 on every seed
LIMITS = {"bf16": {"grad1_gap": 0.024, "change_gap": 0.015}}
