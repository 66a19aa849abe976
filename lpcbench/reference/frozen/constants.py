"""Framework-wide constants (the port's own copy of lpcnet_tpu/constants.py).

These mirror the reference's structural constants so the two packages speak
the same feature/packet language:
  - frame geometry: reference src/freq.h:32-49
  - feature counts & packet sizes: reference include/lpcnet.h:45-53
  - pitch search range: reference src/lpcnet_private.h:14-18
"""

# --- Frame geometry (freq.h:36-46) ---
FRAME_SIZE_5MS = 2
OVERLAP_SIZE_5MS = 2
TRAINING_OFFSET_5MS = 1
WINDOW_SIZE_5MS = FRAME_SIZE_5MS + OVERLAP_SIZE_5MS  # 4

FRAME_SIZE = 80 * FRAME_SIZE_5MS          # 160 samples / 10 ms @ 16 kHz
OVERLAP_SIZE = 80 * OVERLAP_SIZE_5MS      # 160
TRAINING_OFFSET = 80 * TRAINING_OFFSET_5MS  # 80
WINDOW_SIZE = FRAME_SIZE + OVERLAP_SIZE   # 320
FREQ_SIZE = WINDOW_SIZE // 2 + 1          # 161

NB_BANDS = 18
LPC_ORDER = 16
PREEMPHASIS = 0.85

# --- Feature layout (include/lpcnet.h:45-46, lpcnet_enc.c:521-524) ---
NB_FEATURES = 20            # 18 cepstra + pitch period + pitch corr
NB_TOTAL_FEATURES = 36      # + 16 LPC

# --- Codec packet (include/lpcnet.h:49-53) ---
LPCNET_COMPRESSED_SIZE = 8      # bytes per 40 ms packet -> 1.6 kb/s
LPCNET_PACKET_SAMPLES = 640     # 4 frames

# --- Codec internals (lpcnet_private.h:20-23) ---
MULTI = 4
MULTI_MASK = MULTI - 1
FORBIDDEN_INTERP = 7

# --- Pitch search (lpcnet_private.h:14-18) ---
PITCH_MIN_PERIOD = 32
PITCH_MAX_PERIOD = 256

# --- Synthesis network default sizes (training_tf2/train_lpcnet.py:82-101) ---
GRU_A_SIZE = 384
GRU_B_SIZE = 16
COND_SIZE = 128          # feature conditioning width
EMBED_PITCH_SIZE = 64    # pitch embedding dim
EMBED_SIG_SIZE = 128     # mu-law signal embedding dim (diff_Embed)
DUAL_FC_OUT = 256        # mu-law excitation classes
FEATURES_DELAY = 2       # conv lookahead frames (2 convs with kernel 3)

# --- PLC network (training_tf2/lpcnet_plc.py:94-181) ---
PLC_DENSE_SIZE = 128
PLC_GRU_SIZE = 256
PLC_MAX_FEC = 100

# --- DRED / RDO-VAE (training_tf2/train_rdovae.py:142-148) ---
DRED_NUM_FEATURES = 20
DRED_LATENT_DIM = 80
DRED_STATE_DIM = 24
DRED_COND_SIZE = 1024
DRED_PVQ_K = 82
DRED_NUM_QUANT_LEVELS = 16

LOG256 = 5.5451774445
