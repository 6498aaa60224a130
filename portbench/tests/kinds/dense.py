"""The dense kind at the tests' tiny sizes; head_dim 64 and a sequence of
64 let the flash path run."""

SIZES = {"hidden_size": 128, "intermediate_size": 128, "num_attention_heads": 2, "head_dim": 64,
         "num_hidden_layers": 2, "vocab_size": 256, "num_key_value_heads": 2}
#: limits at the tiny sizes, by the cell's ``linear``, set as the cells' own
#: are (between the sound runs' largest reading and the control's or a
#: fault's smallest) from CPU readings: seeds 1-12 sound, 1-4 control and
#: half batch. Sound / control / half batch: bf16 loss 3.7e-4 / 7.5e-4 /
#: 9.1e-3, grad1 1.6e-3 / 9.8e-3 / 0.40, change 2.3e-3 / 3.4e-3 / 0.22;
#: int8 loss 2.5e-3 / 6.9e-3 / 9.9e-3, grad1 1.3e-2 / 0.10 / 0.40, change
#: 7.5e-3 / 0.29 / 0.22
LIMITS = {"bf16": {"loss_gap": 2e-3, "grad1_gap": 5e-3, "change_gap": 0.02},
          "int8": {"loss_gap": 8e-3, "grad1_gap": 0.04, "change_gap": 0.05}}
