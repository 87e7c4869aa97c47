#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on an NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing JSON lines:
  1. device   require CUDA; the card's name and power limit (nvidia-smi)
  2. build    compile mdhs_tpu_torch/csrc/*.cu with nvcc for sm_90a, one
              process per source, all at once
  3. kernels  each CUDA kernel against its plain PyTorch version on the same
              inputs, at the main paths' shapes: the bf16 kernels within
              max |d| <= 6e-2 and mean |d| < 5e-3 (tests/test_fused_attention.py:
              126-127), the int8 kernels within max |d| <= 0.01 * max |plain|
              (tests/test_quant.py:160) and mean |d| < 5e-3; median CUDA-event
              times of kernel and plain version (around one call: the
              wrapper's host launch included), the kernel's device time
              (torch.profiler), the bound (the larger of
              bytes / 3.35 TB/s and operations / peak rate, from this run's
              shapes, each product counted once), and as the library call
              (timing only, CUDA events and the profiler's device time like
              the kernel's) on the same inputs scaled_dot_product_attention
              for fused_attention, grid_sample for shear_sublane and var_mean
              for bn_stats (none for selective_scan and kan_forward: no one
              PyTorch call computes either; kan_forward's line carries its
              two products alone on torch.matmul, float32 with TF32 off and
              the bases made beforehand, as its yardstick gemm_library_ms,
              and bound_rate, the rate its bound reckons the products at:
              the 3xTF32 route, three TF32 products at 494.7 TFLOP/s);
              shear_sublane bit-exact (pads 17 and 31 at 15 degrees, batch
              32; pads 49 and 82 at 45 degrees, batch 32 and 64);
              bn_stats within rtol 1e-5 and
              atol 1e-6 * E|x| (mean) or * E[x^2] (variance) at ResNet50's
              12 BatchNorm inputs at batch 32, and its gradient
              kernel (bn_stats_backward, no library call) at the same shapes
              within one bf16 ulp of each element, and through autograd
              within 1e-5 of the largest gradient (float32); selective_scan (N 16, and
              N 8 and 128) and kan_forward (both layers of the baseline MoE
              bank, and the four of ConNexT's at batch 32: 768 -> 512 with x
              shared, 512 -> 128, 128 -> 32, 32 -> 7)
              within max |d| <= 1e-4 * max |plain| (float32); BERT's flash
              kernels (the forward at batch 32, seq 512, at seq 256 with the
              statistics m, l the backward reads, and seq 200, against SDPA's
              forward with the boolean segment mask; dK/dV and dQ at batch
              32, seq 256 and 512, against SDPA's backward alone, which makes
              dQ, dK and dV together, so one more line at each shape times the
              port's whole backward, dQ (which takes di) + dK/dV, against it)
              on segment ids with masked tiles, the forward within the bf16
              bound (m, l within atol 1e-3, rtol 1e-4), dQ, dK, dV within
              max |d| <= 0.02 * max |plain| and mean |d| <= 2e-3 * max
              |plain|, the dQ kernel's di within 2 D 2^-24 * sum |o * do| of
              its row; the attention kernels' ptxas registers and spills
              (the flash kernels, fused_attention's and the five
              ablations') print on a build line, and beside them those of
              int8_ffn_block's s8 wgmma kernels (ffn_s8_*_kernel<act, tile
              width>, csrc/gemm_sm90.cuh), of shear_sublane_kernel and
              of int8_attention_block's kernels (attn_s8_qkv_kernel<tile
              width>, attn_s8_out_ln_kernel, and int8_attention_core_kernel<NC>,
              fused_attention_kernel<NC>'s code over the packed qkv), and of
              the bf16 sublayers' kernels (bf16_tile_gemm_kernel<act + 1,
              tile width>, bf16_ln_gemm_kernel, the split plan's
              bf16_partial_gemm_kernel and row passes, and
              attention_block_core_kernel<NC>), and of kan_forward_kernel<bn>
              (64 wide, 8 and 16 narrow tiles) and
              selective_scan_kernel<T, S> (ptxas_kan_and_scan);
              int8_attention_block at (8, 128), (8, 256) and the preset's
              (512, 128) and (512, 256), its device time split by stage
              (row quantize of x and ctx, QKV product, attention core, output
              projection + LayerNorm); attention_block at (1, 128) (batch 1,
              the split plan), (8, 128), (8, 256) and (32, 128), its device
              time split by stage (QKV product, core, output projection +
              LayerNorm), and ffn_block at N 128 and 4096, each beside its
              two products alone on torch.matmul (cuBLAS: gemm_library_ms,
              a yardstick of its GEMMs, since no one PyTorch call computes
              a sublayer)
  4. ablate   the attention ablation (ops/attention_ablate.py: the fused
              core with one stage removed, five compile-time variants of
              its mainloop) at the TPU script's shape, B 256, L 128, 12
              heads of 64: each mode against its plain version with zero
              bias and with a bias padding the even rows' keys and N(0, 1)
              in the odd rows, within the bf16 bound over each row's
              max(1, max |plain|) (nosmax reaches 1e10 in a padded row),
              nopv's probabilities within one bf16 ulp each (aligned on
              its head_dim columns); full bit-identical to
              fused_attention and aligned's columns to full's; each mode's
              ms, device ms, plain ms and its own bound (the bytes and
              products that mode does), SDPA with the key mask as full's
              library call; then the diagnostic's own chain
              (diagnostics/attention_ablate.py: 20 calls in a CUDA graph):
              ms per call, the chain's device time split into the kernel
              and the elementwise passes, the kernel's share
  5. slice    full-width MIBF-Net (ResNet50 + BERT-base, 7 labels), bf16,
              exact-parity, seeded random weights, through ServingModel(batch
              32): 3 requests (32, 32, 5 rows, seq 128) via predict_stream with
              attention_block and ffn_block launched 12 times a forward; the
              plain path (attention_impl="xla") on the same weights within
              atol 0.15 and mean |d| < 0.01 (tests/test_fused_attention.py:
              97-105); one request at seq 256; images/s at batch 32, p50
              latency at batch 1, tower times and the device breakdown
  6. preset   the int8 serving preset (configs/serving/mibf_ham_serving.yml:
              fast_math, quantize int8, batch 512) at full width, through
              ServingModel(batch 512): 3 requests (512, 512, 77 rows, seq 128)
              via predict_stream with int8_attention_block and int8_ffn_block
              launched 12 times a forward and no bf16 sublayer kernel; one
              request of 512 rows at seq 256 (the preset's tokenizer length),
              12 launches of each; the same model on the int8 composite
              (models/bert.py::int8_composite()) within 0.25 / 0.03 on logits
              and BERT output (INT8_ATOL says why), and the exact bf16 path
              with CLS drift mean |d| < 0.062 *
              max |CLS| (twice docs/PARITY.md:21's TPU drift); images/s at batch
              512 of the preset and of the exact bf16 model in turns, p50
              latency at batch 1, tower times and the device breakdown, with
              int8_ffn_block's own kernels' device ms a forward
              (int8_ffn_device_ms_per_forward, the int8_ffn_kernels family)
              and int8_attention_block's by stage
              (int8_attention_device_ms_per_forward: its three families and
              the 24 of the forward's 36 row quantizes that it launches, told
              from the FFN's by the next int8 kernel on the stream)
  7. seq512   the exact bf16 MIBF-Net, one request of 32 rows at seq 512:
              fused_attention and ffn_block launched 12 times, attention_block
              none; BERT output and logits within 0.15 / 0.01 of the plain path
  8. baseline the baseline family's two served configurations at full width
              (configs/ham/ham_fusion_ssm_v1.yml: ResNet18 layer4 tokens, BERT-
              base, the Mamba fusion, an MLP head; ham_head_moe_v1.yml: layer2/3/4
              tokens, the multiscale fusion, the KAN-expert MoE head), bf16,
              seeded random weights (w_gate drawn, then made orthogonal to the
              mean fused feature so that rows route apart), through ServingModel(batch
              64): 3 requests (64, 64, 9 rows, seq 128) via predict_stream and
              one of 1 row, with attention_block and ffn_block launched 12
              times a forward and selective_scan once or kan_forward twice;
              the same weights with that op routed to its plain version within
              max |d| <= 2^-6 * max |logit| (two bf16 steps: BF16_STEPS says
              why) and mean |d| <= 2^-10 * max |logit|; images/s at batch 64,
              the share of rows routed to each pair of experts; p50 latency
              at batch 1, forward time and the device breakdown
  9. train    MIBF-Net training at full width (MIBF_HAM_TRAIN: batch 32, seq
              256, canvas 256 -> 224, Adam, cosine, MP-Loss), a bf16 module
              with float32 masters, seeded random weights with each
              bottleneck's last BatchNorm scale at 0.1: Trainer.fit over 2
              epochs x 3 steps (the last batch short, n_valid 21) with
              validation on 2 batches an epoch; shear_sublane launched 3 times
              a step and no serving kernel in a step, attention_block and
              ffn_block 12 times a validation forward; finite losses, masters
              and float32 BatchNorm running statistics updated; one batch's
              augmentation through the kernel and the plain shear bit-exact;
              images/s at batch 32 (host clock, 8 steps), step ms split into
              augmentation, forward + backward and optimizer (CUDA events),
              the device breakdown and the step's share of 989 TFLOP/s; the
              bn_stats A/B on the same weights and batch (one launch of
              bn_stats and one of bn_stats_backward per BatchNorm input the
              gate takes, none in eval, loss within 1e-2 relative of cuDNN
              BatchNorm, step ms of both in turns, each side's device forward
              + backward by kernel family, the two kernels' device ms summed
              over the step beside their summed bounds, and what the
              BatchNorm apply costs), the
              kernel's side a trainer of MIBFNet(bn_stats_kernel=True); one step
              of the bf16 module against a float32 twin on the same weights
              and batch with dropout 0 (loss within 2e-2 relative, per-tower
              gradient cosine >= 0.99; reported, not checked, for the seeded
              weights undamped)
 10. flash    the exact model's weights under attention_impl="flash" at seq
              512, through ServingModel(batch 32): 3 requests (32, 32, 5 rows)
              via predict_stream with flash_attention launched 12 times a
              forward and no other kernel; the same weights on the plain flash
              op within SLICE_ATOL / SLICE_MEAN (BERT output, pad rows
              included, and logits), the logits against the exact model; a
              request at seq 128 (12 launches) and one at seq 200 (none: not a
              multiple of 128); images/s, p50 at batch 1, tower times and the
              device breakdown
 11. train_flash  MIBF_HAM_TRAIN with BERT under "flash" and attention dropout
              0: Trainer.fit over 2 steps and a validation batch; a step
              launches shear_sublane 3 times and each flash kernel 12 times,
              a validation forward the forward 12 times; one step against the
              plain flash op (loss within 1e-2 relative, BERT gradient cosine
              >= 0.99); step ms in turns against the same preset under "auto",
              and both steps' device breakdowns
 12. connext ConNexT served at full width (configs/connext/connext_ham.yml:
              ConvNeXt-base + BERT-base at seq 512, the MoE head of 4 KAN
              experts [768, 512, 128, 32, 7], top-2), bf16, seeded random
              weights with every layer scale at LAYER_SCALE (checked to move the
              map by CONNEXT_SIGNAL of its norm against the init's 1e-6), the
              image-side query and key convolutions scaled by CONNEXT_QK_SCALE
              and w_gate along the rows' principal directions, logits of std
              CONNEXT_GATE_STD (all four experts chosen),
              through ServingModel(batch 32): 3 requests (32, 32, 5 rows) via
              predict_stream and one of 1 row, with fused_attention and
              ffn_block launched 12 times a forward, kan_forward 4 (once on each
              layer of the bank) and nothing else; against the same weights on
              the plain path (BERT under "xla", kan_forward's plain version):
              BERT's CLS within SLICE_ATOL / SLICE_MEAN, the ConvNeXt map bit
              for bit, the head on equal inputs within BF16_STEPS / BF16_MEAN of
              max |logit|, the logits within CONNEXT_LOGIT_MAX / _MEAN of it;
              images/s at batch 32, p50 latency at batch 1, tower and forward
              times and the device breakdown
 12b. train_connext  ConNexT trained at full width through the config-driven
              Trainer (mdhs_tpu_torch/configs/connext_ham.json: batch 32, seq
              512, canvas 256 -> 224, degrees 45, vflip, colour jitter, ImageNet
              normalisation, Adam, CE + balance_weight x the MoE balance loss),
              a bf16 module with float32 masters on phase_connext's stated
              weights: fit over 2 epochs x 2 steps (the second batch short) with
              a validation batch an epoch into a run directory (training.log,
              metrics.jsonl with JAX's tags and the per-class report,
              checkpoints.json, last.pt; removed after); shear_sublane 3 and
              kan_forward 4 a step (its backward the plain VJP), fused_attention
              and ffn_block 12 and kan_forward 4 a validation forward, nothing
              else; finite losses, masters moved; the 45-degree shears (pads 49,
              82) and the jitter bit-exact against the plain shear on the same
              sampled values; one step against the same step on kan_forward's
              plain version (same augmented batch, dropout masks and gating
              noise: loss within CONNEXT_TRAIN_LOSS_REL, the MoE's and BERT's
              gradient cosines >= CONNEXT_TRAIN_GRAD_COS); images/s, step ms
              split into augmentation, forward + backward and optimizer, the
              device breakdown, peak memory (torch.cuda.max_memory_allocated)
 12c. train_baseline  the baseline family trained at full width through the
              config-driven Trainer, each from mdhs_tpu_torch/configs/*.json with
              stain normalisation on (ResNet18 + BERT-base at seq 128, batch 64,
              canvas 256 -> 224, degrees 45, vflip, colour jitter, ImageNet
              normalisation, AdamW, warmup-cosine, bf16 module with float32
              masters), seeded from training.seed: ham_base.json (base.yml:
              multiscale fusion, GroupKAN head) fit over 2 epochs x 2 steps (the
              second batch short) with a validation batch an epoch into a run
              directory (removed after): shear_sublane 3 a step, attention_block
              and ffn_block 12 a validation forward, nothing else; finite losses,
              masters moved, the run's files; the 45-degree shears bit-exact
              against the plain shear; images/s, step ms split into augmentation
              (the stain pass in it), forward + backward and optimizer, the stain
              pass alone (ms, device ms, its bytes bound), the device breakdown,
              peak memory. ham_fusion_ssm_v1.json: a step launches the shears and
              selective_scan once (its backward the associative scan's VJP, plain
              ops), a validation forward the sublayers 12 times and the scan once;
              one step against the same step on the scan's plain version (same
              augmented batch and dropout masks: loss within
              BASELINE_TRAIN_LOSS_REL, the Mamba's and BERT's gradient cosines >=
              BASELINE_TRAIN_GRAD_COS); the backward alone at (64, 49, 512), N 16
              (ms, device ms, bound, memory above its inputs) beside the forward
              kernel's. ham_head_moe_v1.json (w_gate drawn as the baseline
              phase's): kan_forward 2 a step and a validation forward, a step
              against the plain kan_forward with the same gating noise (the same
              bounds, the MoE's and BERT's cosines), and one re-grid
              (training.kan_update_grid_every's: 2 bank layers, an eval forward's
              launches, the grids moved, the kept bank stack remade, the change of
              the validation logits printed); step ms of both
 13. cli     the inference entry points (mdhs_tpu_torch/cli) over a directory of
              CLI_IMAGES seeded 600 x 450 PNGs (HAM10000's size, written by
              data/png.py), a JSON of descriptions and a label CSV, each
              config written resolved as JSON and seeded full-width weights as a
              port checkpoint (float32; it reloads bit for bit); its inputs from
              a generator of its own. MIBF-Net (configs/mibf/mibf_ham.yml:
              ResNet50 + BERT-base, seq 256, batch 32, so 3 batches, the last of
              16 rows): run_predict with TTA off, then on (hflip, vflip, rot90),
              and run_evaluate, each launching attention_block and ffn_block 12
              times a batch (one forward a batch under TTA too) and nothing else;
              the logits with TTA off equal ServingModel.predict of the same
              checkpoint on the same canvases bit for bit, and lie within
              SLICE_ATOL / SLICE_MEAN of the plain path (attention_impl "xla");
              the TTA logits within that bound of the mean of four separate
              kernel forwards of the transformed crops; the CSV holds the rows in
              the label CSV's order with the logits' argmax, and the evaluate
              accuracy is the CSV's; the native resampler ran once an image in
              every run (built before the first, its seconds printed), PIL
              decoded where it imports, and run_evaluate decoded with
              data/png.py, PIL set aside as on a machine without it, whose
              canvases equal PIL's bit for bit. The int8 preset
              (configs/serving/mibf_ham_serving.yml, batch 32 as the CLI takes
              training.batch_size) on the same images: int8_attention_block and
              int8_ffn_block 12 times a batch, the logits within INT8_ATOL /
              INT8_MEAN of the int8 composite. run_ablation_eval on
              ham_fusion_ssm_v1 (batch 64, 64 images): full_fusion, image_only,
              text_off, with selective_scan launched 2 times (full_fusion and
              text_off; image_only runs no text tower and no fusion). run_predict
              --family connext on connext_ham.yml (32 images): fused_attention,
              ffn_block and kan_forward 12 / 12 / 4 times. For each run, as
              information: host-clock images/s, the host's decode, resize and
              tokenize ms, and the forward's device ms (trace.whole_trace) with
              the device's busy share of the run
 14. export  the exported artifact (cli/export_serving.py -> serving.py::
              ServingModel.load), from the cli phase's configs and checkpoints
              (its directory is removed after this phase): the preset
              (mibf_ham_serving, batch 512, seq 256), mibf_ham with --tta
              (batch 32) and at a static batch of 1, mibf_ham under
              attention_impl="flash" at seq 512 (batch 32), ham_fusion_ssm_v1
              (batch 64) and connext_ham (batch 32, seq 512), all at full width
              and depth. For each: export seconds, artifact bytes, load
              seconds; its launches a forward, equal to the live
              ServingModel's on the same checkpoint and to the path's own (the
              eight torch.ops.mdhs ops among them); logits bit for bit equal to
              the live ones on a full and a partial batch; sync_free; device ms
              a forward (trace.whole_trace), live and artifact, and what the
              host runs for one forward of each (host_ops: torch.profiler's CPU
              op records); predict_stream images/s and the p50 of one-row
              requests at the static batch, live and artifact in turns (live,
              artifact, artifact, live), host clock. run_serve with the TTA
              artifact over the cli phase's PNGs writes run_predict's TTA CSV
              byte for byte. Then dispatch_cost_b1: host us a call of the
              ffn_block and attention_block ops against their CUDA
              implementations called directly, at BERT-base's batch-1 shapes,
              and the live batch-1 p50 of the exact MIBF model and the two
              baseline configurations with the wrappers calling the ops and
              calling the launches directly, four turns of each
 13b. train_cli  (between cli and export, on the cli phase's PNGs) python3 -m
              mdhs_tpu_torch.cli.run_train --family mibf on mibf_ham.json (batch
              32, seq 256) over 64 train and 16 val images for 2 epochs from a
              seeded full-width start (model.pretrained_path, residual-branch
              BatchNorm damped): the run directory's files, finite losses, at
              most 3 checkpoints best first and last.pt; shear_sublane 3 a step,
              attention_block and ffn_block 12 a validation batch, nothing else;
              the best checkpoint bit for bit the trainer's state at its epoch,
              in the file and in a fresh model; run_predict over it within
              SLICE_ATOL / SLICE_MEAN of the trainer's eval forward on the same
              images (bit-equal reported); a resume from last.pt for a third
              epoch starts at the saved step and schedule position
 13c. train_baseline_cli  (after train_cli, on the cli phase's PNGs) python3 -m
              mdhs_tpu_torch.cli.run_train (the family defaulting to baseline) on
              ham_base.json with stain normalisation (batch 64, seq 128) over 64
              train and 16 val images for 2 epochs from the seeded init: the run
              directory's files; shear_sublane 3 a step, attention_block and
              ffn_block 12 a validation batch, nothing else; the best checkpoint
              bit for bit the trainer's state at its epoch; run_predict (the
              family defaulting to baseline) over it, 12 + 12 launches, within
              SLICE_ATOL / SLICE_MEAN of the trainer's eval forward (bit-equal
              reported)
 17. spine    (last) seeded numbered slices p{k:03d}_slice_{i:03d}.png, gray /
              RGB / RGBA, with gaps for both neighbour fallbacks, descriptions, a
              6-class label CSV and a HAM-style metadata CSV; run_train of
              spine_sequence_lstm_v1.json at batch 64 x 5 slices (ResNet18 over
              320 images a step, BERT-base at seq 128, the bidirectional LSTM):
              3 steps and a validation batch, shear_sublane 3 a step (N = 320),
              attention_block and ffn_block 12; the (64, 5) stack's augmentation
              bit for bit against the plain shear and a step against the same
              step on it (BASELINE_TRAIN_LOSS_REL, BASELINE_TRAIN_GRAD_COS);
              step ms by part, device ms, busy share, records/s and slices/s; the
              LSTM's bf16 loop against cuDNN's nn.LSTM, each against the float32
              loop. The seven branch configurations (gate, global/local,
              multi-view, sequence transformer, pseudo-2.5D, HAM gate, HAM
              tabular) and the HAM gate with the MoE head served at batch 32 on
              their own datasets' records: 12 + 12 launches a forward (4
              kan_forward with the MoE head), the logits against BERT's two
              sublayers on their plain versions within BF16_STEPS of the
              largest logit, mean within CONNEXT_LOGIT_MEAN of it and under
              SLICE_MEAN; with the MoE head, kan_forward alone on its plain
              version, as phase baseline holds it (BF16_STEPS, BF16_MEAN of
              the largest logit); sync_free, CUDA-event and device ms. ham_tabular_v1
              trained 2 steps, exported with its tabular input at batch 64,
              loaded by ServingModel.load: launches and logits as the live
              model's bit for bit, run_serve's CSV run_predict's
 18. fusion   (after spine) the baseline's seven remaining fusions through the
              configurations that name them (mdhs_tpu_torch/configs/
              ham_fusion_{crossattn,weighted,hadamard,bilinear,vmamba}_v1,
              ham_tta_attention_basic_mlp_v1, spine_hierarchical_v1), on 256
              records over 64 seeded 600 x 450 PNGs (FUSION_DIR, removed
              after): each served live at full width, batch 64, seq 128 (the
              TTA configuration one fused forward of 256 rows): 12 + 12
              launches a forward and 2 selective_scan with vmamba; the logits
              against BERT's two sublayers on their plain versions (vmamba:
              selective_scan alone) at the spine phase's bounds; CUDA-event
              and device ms, busy share, sync_free. run_train of
              ham_fusion_vmamba_v1 (3 steps: 3 shears and 2 scans a step, the
              scans' backward the associative VJP) with a step against the
              plain scan (BASELINE_TRAIN_LOSS_REL, BASELINE_TRAIN_GRAD_COS),
              step ms and device ms; of ham_fusion_crossattn_v1 and
              spine_hierarchical_v1 (2 steps); run_predict of the TTA
              configuration over the crossattn run's best checkpoint, bit for
              bit the live TTA server; the vmamba and hierarchical artifacts
              bit for bit their live models with the same launches. The
              kernels phase holds selective_scan at (64, 49, 64), N 16 too
 19. mamba    (after fusion) 64 seeded 600 x 450 PNGs under 256 names and a
              seeded hidden-state JSON (3,584-wide first and last vectors of
              ConNexT's 96 records, one left out); ham_mamba_vision_v1
              (MambaVision-T at 224 + BERT-base, basic fusion, mlp head) served
              at batch 64, seq 128: 12 + 12 launches and 6 selective_scan a
              forward, the logits against BERT's sublayers on plain
              (BF16_STEPS, min(SLICE_MEAN, CONNEXT_LOGIT_MEAN) of the largest
              logit) and against the scan alone on plain (BF16_STEPS,
              BF16_MEAN); ConNexT with the multimodal Mamba fusion served at
              batch 32, seq 512 with hidden vectors: 12 fused_attention, 12
              ffn_block, 1 selective_scan and 3 kan_forward a forward, the
              logits against BERT on plain (CONNEXT_LOGIT_MAX / _MEAN) and
              against the scan and kan_forward on plain (BF16_STEPS,
              BF16_MEAN), the fusion's output in float32 against its plain ops
              (F32_FRAC); ms, device ms, busy share, sync_free. run_train of
              both (3 steps at batch 64; 2 at batch 32 over the hidden JSON, the
              left-out record's vectors zeros) with a step against the plain
              ops (BASELINE_TRAIN_LOSS_REL, BASELINE_TRAIN_GRAD_COS); run_predict
              of the fusion with TTA and the hidden vectors, bit for bit the
              live TTA server; both exported and held bit for bit against their
              live models (the fusion's artifact takes no hidden input). The
              kernels phase holds selective_scan at (64, 196, 160) and (64, 49,
              320), N 8, and (32, 52, 512), N 128, and kan_forward as one layer
              at (1664, 256) -> 256
 20. analysis (after mamba) 48 seeded 600 x 450 PNGs under 96 names (two
              batches of 64, the second padded); for ham_base.json (ResNet18,
              multiscale, GroupKAN) and ham_mamba_vision_v1.json (MambaVision-T,
              basic), BERT-base at seq 128, bf16, seeded weights saved as a
              port checkpoint: run_analysis.main with 80 CAMs (48 / 48
              attention_block / ffn_block and 24 selective_scan for
              MambaVision: a feature forward and a CAM step each batch), the 80
              overlays read back as (224, 224, 3) uint8 PNGs, the printed line
              the returned effective rank; a CAM step (12 / 12, + 6 scans)
              against the same step with BERT's sublayers (and the scan) on
              their plain versions: the logits within BF16_STEPS of the
              largest, the averaged CAM on the rows of one class within the
              CAM_* bounds, the feature rank within RANK_REL; the CAM step's
              and the feature forward's ms, device ms, busy share and peak
              memory beside the card's name and power limit; then a seeded
              full-width ConNexT (connext_ham.json) saved as a bare reference
              file and as a Lightning checkpoint under net.net. with its tower
              under torchvision's names, each loaded by load_weights: the
              served logits bit for bit the same
Every device breakdown (device_profile) comes from a trace checked to hold
whole calls: a census of one call against two names the kernels every call
launches, and a trace that lost a record of one is taken again; the census,
the records and the wrappers' launches of one call print beside it.
Every served phase (slice, preset, seq512, flash, baseline, connext, export, spine, fusion, mamba) runs one warm
forward from device-resident inputs under torch.cuda.set_sync_debug_mode(
"error") ("sync_free"): a call that makes the host wait on the device fails
the script.
Then a JSON line of each phase's seconds (host clock, "phase_seconds"), a
JSON line of the kernels (each with its launches on every path that
launched it, "launches_by_path"; kan_forward's entry with its seven layers'
numbers under "layers", each with the launches the baseline, connext or
mamba phase counted for its (IN, OUT)), the nvidia-smi line, and the result line.
Each path sets every launch count to 0 just before it runs and reads them
just after. Any failure raises: the exit code is not 0 and no result line is
printed.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import cProfile
import dataclasses
import gc
import importlib.util
import io
import json
import pstats
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mdhs_tpu_torch import native, resolve_device
from mdhs_tpu_torch.analysis.feature_rank import FeatureRankAnalyzer
from mdhs_tpu_torch.cli import common as cli_common
from mdhs_tpu_torch.cli import (export_serving, run_ablation_eval, run_analysis, run_evaluate, run_predict, run_serve,
                                run_train)
from mdhs_tpu_torch.core.checkpoint import TopKCheckpointManager, load_torch_file, load_weights, save_checkpoint
from mdhs_tpu_torch.core.config import load_config
from mdhs_tpu_torch.data import datasets as cli_data
from mdhs_tpu_torch.data import png
from mdhs_tpu_torch.data.loader import DataLoader
from mdhs_tpu_torch.data.tokenizer import load_tokenizer
from mdhs_tpu_torch.diagnostics import attention_ablate as diag
from mdhs_tpu_torch.diagnostics import trace
from mdhs_tpu_torch.models import build_model
from mdhs_tpu_torch.models.baseline import MultimodalBaselineModel
from mdhs_tpu_torch.models.bert import BertConfig, int8_composite
from mdhs_tpu_torch.models.connext import ConNexTClassifier
from mdhs_tpu_torch.models.init import init_parameters
from mdhs_tpu_torch.models.mibf import MIBFNet
from mdhs_tpu_torch.models.norm import BatchNorm2d
from mdhs_tpu_torch.modules.kan import KANLinear, make_grid
from mdhs_tpu_torch.modules.moe import noisy_top_k_gating
from mdhs_tpu_torch.ops import _build
from mdhs_tpu_torch.ops import attention_ablate as aa
from mdhs_tpu_torch.ops import attention_block as ab
from mdhs_tpu_torch.ops import augment as aug
from mdhs_tpu_torch.ops import bn_stats as bns
from mdhs_tpu_torch.ops import ffn_block as fb
from mdhs_tpu_torch.ops import flash_attention as fl
from mdhs_tpu_torch.ops import fused_attention as fa
from mdhs_tpu_torch.ops import kan_spline as ks
from mdhs_tpu_torch.ops import quant_kernel as qk
from mdhs_tpu_torch.ops import selective_scan as ss
from mdhs_tpu_torch.ops import shear as sh
from mdhs_tpu_torch.ops.preprocess import eval_pipeline
from mdhs_tpu_torch.ops.stain_norm import stain_normalize
from mdhs_tpu_torch.ops.quant import quantize_weight
from mdhs_tpu_torch.ops.tta import tta_variants
from mdhs_tpu_torch.presets import (BASELINE_BATCH, BASELINE_SEQ, CONNEXT_BATCH, CONNEXT_CROP, CONNEXT_HAM,
                                    CONNEXT_SEQ, HAM_FUSION_SSM, HAM_HEAD_MOE, MIBF_HAM_SERVING)
from mdhs_tpu_torch.serving import ServingModel
from mdhs_tpu_torch.train.trainer import MIBF_HAM_TRAIN, Trainer

MAX_ABS, MEAN_ABS = 6e-2, 5e-3           # bf16 kernel vs plain version
INT8_FRAC = 0.01                         # int8 kernel vs plain: max |d| <= 0.01 * max |plain|
SLICE_ATOL, SLICE_MEAN = 0.15, 0.01      # kernel vs plain model path, bf16
# int8 kernels vs the int8 composite. The composite rounds the dequantized
# products to bf16 before the GELU, the residual and each re-quantization
# (the kernels do not: quant_kernel.py:127-129 names the GELU one as the
# intended difference); a bf16 rounding moves x / scale by up to a quarter
# int8 step, so the two paths differ by flipped int8 values, at the size of
# the int8 drift itself. Measured on the card at batch 512: BERT output max
# 0.156, mean 0.020; logits max 0.061, mean 0.014. The bound keeps 1.5x.
INT8_ATOL, INT8_MEAN = 0.25, 0.03
CLS_DRIFT = 0.062                        # int8 preset vs exact bf16: mean |d CLS| < 0.062 * max |CLS|
BATCH, SEQ, LONG_SEQ, CANVAS, LABELS = 32, 128, 256, 256, 7
SEQ512 = 512
VOCAB = 30522
HD, HEADS, DI = 768, 12, 3072
# bn_stats vs its two-pass plain version: float32 sums in another order; a
# mean near zero has no relative precision, so the atol scales with the data
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6      # atol * E|x| on the mean, * E[x^2] on the variance
# bf16 training step against a float32 twin on the same weights and batch, dropout 0
MIXED_LOSS_REL, MIXED_GRAD_COS = 2e-2, 0.99
BN_AB_LOSS_REL = 1e-2                    # bn_stats kernel vs cuDNN BatchNorm, one step's loss
F32_FRAC = 1e-4                          # float32 kernels vs plain: max |d| <= 1e-4 * max |plain|
# the flash backward kernels vs their plain versions: p and ds are rounded to bf16 from the
# kernel's own float32 scores, so a rounding apart moves a gradient by a bf16 step of its largest term
GRAD_FRAC, GRAD_MEAN = 0.02, 2e-3
FLASH_LOSS_REL, FLASH_GRAD_COS = 1e-2, 0.99  # a flash training step vs the same step on the plain flash op
# A baseline model with a float32 kernel vs the same weights with its plain op: the
# two agree to ~1e-6 relative, which flips a bf16 rounding now and then downstream
# (the scan's and each KAN layer's outputs are cast to bf16, the MLP head's logits
# are bf16): max |d| within two bf16 steps of the largest logit (2^-6 of it), mean
# |d| within 2^-10 of it. Relative, as the two heads' logits differ in scale by 10^3.
BF16_STEPS, BF16_MEAN = 2.0 ** -6, 2.0 ** -10
# The train phase's ResNet50 takes each bottleneck's last BatchNorm scale at
# 0.1: with every scale at 1 (the seeded init) a training-mode ResNet50 is
# chaotic, so a bf16 step and a float32 step differ by the weights'
# conditioning, not by their arithmetic (the phase reports that comparison
# too: "seeded_init"; the JAX package's own bf16 step reads as low on these
# weights, tests/test_torch_port_mixed_precision.py). A trained ResNet's
# residual branches are damped (torchvision's zero_init_residual takes them to 0).
RESIDUAL_BN_SCALE = 0.1
# The connext phase's ConvNeXt-base takes every layer scale at 0.5: at the seeded init's 1e-6
# each of its 36 blocks adds ~1e-6 of its branch, so the map would be the stem and the
# downsampling convolutions alone and a wrong block would pass unseen. At 0.5 a block adds about
# a third of a unit-variance branch to the stream, and the 27 of stage 2 take it to about four
# times its variance: the map holds every block and stays far from bf16's range (the phase
# checks the map moves by at least CONNEXT_SIGNAL of its norm against the init's layer scales).
LAYER_SCALE, CONNEXT_SIGNAL = 0.5, 0.1
# ConNexT's image-side cross-attention softmax is unscaled (the reference's): Q from BERT's CLS,
# K from the 49 positions, dot products over 768 channels of order 1, so seeded weights give scores
# of tens and a saturated softmax, where one bf16 ulp of the CLS (kernel path against plain path)
# can move the winning position. Its query and key convolutions are scaled by 768^-0.25 each:
# the scores of a 1/sqrt(768)-scaled softmax, which the phase prints (imag_scores).
CONNEXT_QK_SCALE = 768 ** -0.25
# ConNexT's logits on the kernel path against the plain path. The paths differ in BERT (bf16
# kernels against the module path), whose CLS moves by up to SLICE_ATOL of a max |CLS| of order 4,
# a few percent, and in the KAN bank (float32, ~1e-6); the head is smooth where its softmaxes are off
# saturation and no row's top-2 experts lie within that difference of a tie (CONNEXT_GATE_STD). The
# seeded four-layer bank gives logits of order 1e-2, so the bound is relative: max |d| within 2^-4 of
# the largest logit, mean |d| within 2^-7 of it.
CONNEXT_LOGIT_MAX, CONNEXT_LOGIT_MEAN = 2.0 ** -4, 2.0 ** -7
# ConNexT's MoE gate (zero at init: every row routes alike) is set along the principal directions of
# the first request's fused features, its logits spread with std 2 over the rows: the top-1 expert
# takes most of a row's weight and the second the rest (the phase prints the mean top-1 gate), and
# no row lies within the two paths' bf16 noise of a tie (_gate_along_row_spread says why a random
# gate does not do that here)
CONNEXT_GATE_STD = 2.0
CONNEXT_BANK = (768, 512, 128, 32, 7)  # the MoE head's KAN experts (modules/moe.py's default stack)
# A ConNexT training step with kan_forward's kernel against the same step on its plain version (the
# same weights, augmented batch, dropout masks and gating noise): the kernel's 3xTF32 products sit
# ~1e-6 relative from float32, which a bf16 cast after each bank layer turns into a bf16 step now and
# then; the loss within 1e-2 relative and the MoE bank's and BERT's gradient cosines >= 0.99, the
# bounds of the flash and bf16 steps above
CONNEXT_TRAIN_LOSS_REL, CONNEXT_TRAIN_GRAD_COS = 1e-2, 0.99
# A baseline training step with selective_scan's or kan_forward's kernel against the same step on the
# op's plain version (the same weights, augmented batch, dropout masks and gating noise): float32 kernels
# ~1e-6 relative from their plain versions, whose outputs are cast to bf16 downstream; the bounds of the
# ConNexT step above: loss within 1e-2 relative, the Mamba's (the MoE's) and BERT's gradient cosines >= 0.99
BASELINE_TRAIN_LOSS_REL, BASELINE_TRAIN_GRAD_COS = 1e-2, 0.99
# The cli phase's inputs: HAM10000's 600 x 450 dermoscopy images, the batch's three TTA variants
CLI_IMAGES, CLI_H, CLI_W = 80, 450, 600
CLI_TTA = ("hflip", "vflip", "rot90")
CLI_WORDS = ("lesion", "pigment", "network", "border", "irregular", "asymmetric", "nevus", "melanoma", "dermoscopy",
             "globules", "streaks", "blue-white", "veil", "regression", "vascular", "keratosis", "benign", "atypical",
             "papule", "macule", "patient", "reports", "itching", "growth", "months,", "colour;", "diameter", "mm.")
# ResNet50's BatchNorm inputs at training batch 32 as (rows, channels): 53 inputs of 12 shapes
RESNET50_BN_B32 = ((401408, 64), (100352, 256), (1568, 2048), (100352, 64), (25088, 512), (100352, 128),
                   (25088, 128), (6272, 1024), (25088, 256), (6272, 256), (6272, 512), (1568, 512))
# H100 SXM datasheet peaks at 700 W: bytes/s of HBM, dense ops/s (float32 outside the tensor cores)
HBM_BPS, BF16_OPS, INT8_OPS, F32_OPS = 3.35e12, 989e12, 1979e12, 67e12
TF32_OPS = 494.7e12  # dense TF32 on the tensor cores (kan_forward's 3xTF32 products)

KERNELS = {  # name: (module, source, TPU kernel it replaces)
    "attention_block": (ab.attention_block, "mdhs_tpu_torch/csrc/attention_block.cu",
                        "mdhs_tpu/ops/attention_block.py:110"),
    "ffn_block": (fb.ffn_block, "mdhs_tpu_torch/csrc/ffn_block.cu", "mdhs_tpu/ops/ffn_block.py:80"),
    "fused_attention": (fa.fused_attention, "mdhs_tpu_torch/csrc/fused_attention.cu",
                        "mdhs_tpu/ops/fused_attention.py:103"),
    "int8_ffn_block": (qk.int8_ffn_block, "mdhs_tpu_torch/csrc/int8_ffn_block.cu",
                       "mdhs_tpu/ops/quant_kernel.py:97"),
    "int8_attention_block": (qk.int8_attention_block, "mdhs_tpu_torch/csrc/int8_attention_block.cu",
                             "mdhs_tpu/ops/quant_kernel.py:230"),
    "shear_sublane": (sh.shear_sublane, "mdhs_tpu_torch/csrc/shear.cu", "mdhs_tpu/ops/shear.py:93"),
    "bn_stats": (bns.bn_stats, "mdhs_tpu_torch/csrc/bn_stats.cu", "mdhs_tpu/ops/bn_stats.py:138"),
    # the custom VJP's backward (XLA ops in the JAX package) as one hand-written pass
    "bn_stats_backward": (bns.bn_stats_backward, "mdhs_tpu_torch/csrc/bn_stats.cu", "mdhs_tpu/ops/bn_stats.py:190"),
    "selective_scan": (ss.selective_scan, "mdhs_tpu_torch/csrc/selective_scan.cu",
                       "mdhs_tpu/ops/selective_scan.py:112"),
    "kan_forward": (ks.kan_forward, "mdhs_tpu_torch/csrc/kan_spline.cu", "mdhs_tpu/ops/kan_spline.py:114"),
    # the library kernels mdhs_tpu/models/bert.py:207 calls under attention_impl="flash" (jax 0.9.0)
    "flash_attention": (fl.flash_attention_forward, "mdhs_tpu_torch/csrc/flash_attention.cu",
                        "jax/experimental/pallas/ops/tpu/flash_attention.py:758"),
    "flash_attention_bwd_dkv": (fl.flash_attention_bwd_dkv, "mdhs_tpu_torch/csrc/flash_attention.cu",
                                "jax/experimental/pallas/ops/tpu/flash_attention.py:1121"),
    "flash_attention_bwd_dq": (fl.flash_attention_bwd_dq, "mdhs_tpu_torch/csrc/flash_attention.cu",
                               "jax/experimental/pallas/ops/tpu/flash_attention.py:1456"),
    # the ablation diagnostic's kernel, make_kernel (:27) reached through build(mode).op
    "attention_ablate": (aa.attention_ablate, "mdhs_tpu_torch/csrc/attention_ablate.cu",
                         "benchmarks/attention_ablate.py:67"),
}


# host seconds between marks: each emitted line (or an explicit mark) closes the span since the
# previous one, under its label; the phase-seconds line prints them
SPANS: list = []
_SPAN_START = [time.perf_counter()]


def mark(label: str) -> None:
    now = time.perf_counter()
    SPANS.append([label, now - _SPAN_START[0]])
    _SPAN_START[0] = now


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)
    mark("/".join(str(obj[k]) for k in ("phase", "part", "kernel", "shape", "config") if k in obj))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def zero_counts() -> None:
    for fn, _, _ in KERNELS.values():
        fn.launches = 0
    ks.kan_forward.launches_by_layer = {}


def read_counts() -> dict:
    return {name: fn.launches for name, (fn, _, _) in KERNELS.items()}


def cuda_ms(fn, warmup: int = 2, reps: int = 10) -> float:
    """Median of per-call CUDA-event times after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def diff(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    d = (out.float() - ref.float()).abs()
    return d.max().item(), d.mean().item()


# kernel family <- name fragments, first match wins (cuDNN's implicit-GEMM
# convolutions are "fprop" kernels, so they are tested before cuBLAS's GEMMs, and
# the port's own GEMM kernels before both)
_FAMILIES = {
    # int8_ffn_block's own kernels (csrc/int8_ffn_block.cu): GEMM1's two passes, the row
    # scale, GEMM2 + LayerNorm; its row quantize of x is in row_quantize_kernel
    "int8_ffn_kernels": ("ffn_s8_", "ffn_row_scale_kernel"),
    # int8_attention_block's own kernels (csrc/int8_attention_block.cu), a family a stage: the
    # QKV product, the attention core (fused_attention's mainloop over the packed qkv), the
    # output projection + LayerNorm; its two row quantizes are in row_quantize_kernel
    "int8_attention_qkv": ("attn_s8_qkv_kernel",),
    "int8_attention_core": ("int8_attention_core_kernel",),
    "int8_attention_out_ln": ("attn_s8_out_ln_kernel",),
    "flash_attention_kernels": ("flash_forward_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel"),
    "selective_scan_kernel": ("selective_scan_kernel",),
    "kan_forward_kernel": ("kan_forward_kernel",),
    "shear_kernel": ("shear_sublane_kernel",),
    "bn_stats_backward_kernel": ("bn_stats_backward_kernel",),
    "bn_stats_kernel": ("bn_stats_kernel",),
    "row_quantize_kernel": ("row_quantize_kernel",),
    # the bf16 sublayers' own kernels (csrc/bf16_gemm.cu, csrc/attention_block.cu): the tile GEMM (QKV
    # product, FFN GEMM1) with its split row pass, the LayerNorm GEMM (both output products) with its,
    # the split products' partial tiles, the attention block's core (fused_attention's mainloop over the
    # packed qkv)
    "bf16_tile_gemm": ("bf16_tile_gemm_kernel", "bias_act_rows_kernel"),
    "bf16_ln_gemm": ("bf16_ln_gemm_kernel", "ln_rows_kernel"),
    "bf16_split_partials": ("bf16_partial_gemm_kernel",),
    "attention_block_core": ("attention_block_core_kernel",),
    "fused_attention_kernel": ("fused_attention_kernel",),
    "cudnn_conv": ("fprop", "dgrad", "wgrad", "conv"),
    "batch_norm": ("batch_norm",),
    "cublas_gemm": ("nvjet", "gemm", "cublas"),
    # PyTorch's own kernels, which the training step adds
    "layer_norm": ("layer_norm",),
    "softmax": ("softmax",),
    "dropout": ("dropout",),
    "optimizer_foreach": ("multi_tensor_apply",),
    "elementwise": ("elementwise",),
    "reduce": ("reduce_kernel",),
    "copy_cat": ("copy", "cat"),
}


def device_profile(fn, forward_ms: float, reps: int = 3, top: int = 0) -> dict:
    """Device time per call by kernel family (torch.profiler, CUDA events
    only), its share of the unprofiled CUDA-event time of the call, and the
    ``top`` kernels by device time; from a trace checked to hold whole calls
    (trace.whole_trace: the census of one call against two names the kernels
    every call launches, and a trace that lost a record of one is taken
    again). The census and the wrappers' launches of one call go beside it."""
    saved = read_counts()
    zero_counts()
    fn()
    launches = {k: v for k, v in read_counts().items() if v}
    for name, (wrapper, _, _) in KERNELS.items():
        wrapper.launches = saved[name]
    events, census = trace.whole_trace(fn, reps)
    kernels = trace.by_kernel(events, reps)
    by = dict.fromkeys([*_FAMILIES, "other"], 0.0)
    for name, ms, _ in kernels:
        low = name.lower()
        by[next((f for f, frags in _FAMILIES.items() if any(x in low for x in frags)), "other")] += ms
    busy = sum(by.values())
    out = {"kernel_ms": busy, "busy_share": busy / forward_ms, "by_family_ms": by,
           "records_a_call": len(events) / reps, "census": census, "launches_a_call": launches,
           "markers_held": events.held}
    if top:
        out["top_kernels"] = [{"name": n[:120], "ms": ms, "launches": c}
                              for n, ms, c in sorted(kernels, key=lambda k: -k[1])[:top]]
    return out


def int8_attention_stages(fn, reps: int = 10, blocks: int = 1, alone: bool = True) -> dict:
    """int8_attention_block's device time a call of fn by stage: its own kernels by name, and its
    row quantizes by launch order, the ones whose next int8 kernel on the stream is the block's
    (x's before the QKV product, ctx's before the output projection; the FFN's own quantize of x
    is followed by ffn_s8_*). fn calls the block ``blocks`` times, and a trace that lost any of
    their kernels is taken again. ``alone``: fn is one call of the block and nothing else."""
    stages = {"qkv": "attn_s8_qkv_kernel", "core": "int8_attention_core_kernel",
              "out_ln": "attn_s8_out_ln_kernel"}
    def whole(events):
        return all(sum(frag in e.name for e in events) == reps * blocks for frag in stages.values())

    events = trace.kernel_events(fn, reps, whole)
    kernels = [(e.time_range.start, e.name, e.time_range.elapsed_us() / 1e3 / reps) for e in events]
    out = {s: sum(ms for _, n, ms in kernels if frag in n) for s, frag in stages.items()}
    launches = {s: sum(frag in n for _, n, _ in kernels) for s, frag in stages.items()}
    quantizes, pending = [], []
    for _, n, ms in kernels:
        if "row_quantize_kernel" in n:
            pending.append(ms)
        elif "ffn_s8_" in n or any(frag in n for frag in stages.values()):
            quantizes += [] if "ffn_s8_" in n else pending
            pending = []
    out["row_quantize_x_and_ctx"] = sum(quantizes)
    check(len(quantizes) == 2 * launches["qkv"] == 2 * launches["out_ln"] > 0,
          f"int8 attention: {len(quantizes)} row quantizes for {launches}")
    if alone:
        check(abs(sum(out.values()) - sum(ms for _, _, ms in kernels)) < 1e-9, f"int8 attention kernels {kernels}")
    return out


def attention_block_stages(fn, reps: int = 10) -> dict:
    """attention_block's device time a call by stage: the QKV product (its tile GEMM, or its
    split's row pass), the core, the output projection + LayerNorm (its clustered LayerNorm GEMM,
    or its split's row pass); a split product's partial tiles count for the stage of the row pass
    that follows them. fn is one call of the block and nothing else."""
    stage_of = {"bf16_tile_gemm_kernel": "qkv", "bias_act_rows_kernel": "qkv", "attention_block_core_kernel": "core",
                "bf16_ln_gemm_kernel": "out_ln", "ln_rows_kernel": "out_ln"}
    out, pending = dict.fromkeys(("qkv", "core", "out_ln"), 0.0), 0.0
    for e in trace.kernel_events(fn, reps, trace.whole_calls(reps)):
        ms = e.time_range.elapsed_us() / 1e3 / reps
        if "bf16_partial_gemm_kernel" in e.name:
            pending += ms
            continue
        stage = next((s for frag, s in stage_of.items() if frag in e.name), None)
        check(stage is not None, f"attention_block: kernel {e.name} of no stage")
        out[stage] += ms + pending
        pending = 0.0
    check(pending == 0.0, "attention_block: partial tiles with no row pass after them")
    return out


def _sublayer_products(name, args):
    """The bf16 sublayer's two matrix products alone on torch.matmul (cuBLAS), on its inputs'
    shapes: the yardstick of its GEMMs (no one PyTorch call computes the sublayer)."""
    if name == "attention_block":
        x, wqkv, _, wo = args[:4]
        x2 = x.view(-1, x.shape[-1])
        return lambda: (torch.matmul(x2, wqkv.t()), torch.matmul(x2, wo.t()))
    x, w1, _, w2 = args[:4]
    h = torch.empty((x.shape[0], w1.shape[0]), dtype=x.dtype, device=x.device).normal_(0.0, 0.1)
    return lambda: (torch.matmul(x, w1.t()), torch.matmul(h, w2.t()))


def kernel_device_ms(fn, reps: int = 10) -> float:
    """Device time of one call (the sum of its kernels' times), without the
    host's launch overhead that CUDA events around a short call include."""
    return sum(ms for _, ms, _ in trace.by_kernel(trace.kernel_events(fn, reps, trace.whole_calls(reps)), reps))


def passes_device_ms(fn, reps: int = 3) -> float:
    """kernel_device_ms of a call of many plain PyTorch passes (some hundred records a
    call), from a trace checked by trace.whole_trace, which takes the census again
    where each try lost a record."""
    return sum(ms for _, ms, _ in trace.by_kernel(trace.whole_trace(fn, reps)[0], reps))


# --- bounds: the least time the card could take for each kernel's work -------
def _bound(bytes_moved: float, ops_s: float) -> tuple[float, str]:
    mem_s = bytes_moved / HBM_BPS
    return max(mem_s, ops_s) * 1e3, "bytes" if mem_s >= ops_s else "operations"


def bound_attention_block(B, L):
    M, D = B * L, HD // HEADS
    flops = 2 * M * HD * 3 * HD + 4 * B * HEADS * L * L * D + 2 * M * HD * HD
    nbytes = 2 * (2 * M * HD) + 2 * (4 * HD * HD + 6 * HD) + 4 * B * L
    return _bound(nbytes, flops / BF16_OPS)


def bound_ffn_block(N):
    nbytes = 2 * (2 * N * HD) + 2 * (2 * HD * DI + DI + 3 * HD)
    return _bound(nbytes, 4 * N * HD * DI / BF16_OPS)


def bound_int8_ffn_block(N):
    nbytes = 2 * (2 * N * HD) + 2 * HD * DI + 4 * (2 * DI + 4 * HD)
    return _bound(nbytes, 4 * N * HD * DI / INT8_OPS)


def bound_int8_attention_block(B, L):
    M, D = B * L, HD // HEADS
    ops_s = 8 * M * HD * HD / INT8_OPS + 4 * B * HEADS * L * L * D / BF16_OPS
    nbytes = 2 * (2 * M * HD) + 4 * HD * HD + 4 * (6 * HD + 4 * HD) + 4 * B * L
    return _bound(nbytes, ops_s)


def bound_fused_attention(B, L):
    D = HD // HEADS
    return _bound(2 * (4 * B * L * HD) + 4 * B * L, 4 * B * HEADS * L * L * D / BF16_OPS)


def bound_attention_ablate(mode, B, L):
    # what each mode does: full, nomax, nosmax read q, k, v and the bias and write ctx, with
    # Q K^T and P V; nopv reads no V and does no P V; aligned reads one head of q, k, v and
    # writes its D columns, but computes every head's products
    tensor = 2 * B * L * HD  # one (B, L, HD) bf16 tensor
    tensors, products = {"nopv": (3, 1), "aligned": (4 / HEADS, 2)}.get(mode, (4, 2))
    return _bound(tensors * tensor + 4 * B * L, products * 2 * B * HEADS * L * L * (HD // HEADS) / BF16_OPS)


def _flash_bound(B, L, operands, stats, products):
    # ``operands`` (B, L, HD) bf16 tensors read or written once, the int32 segment ids,
    # ``stats`` (B, heads, L) float32 rows, ``products`` (B, heads, L, L, D) matrix products
    nbytes = 2 * operands * B * L * HD + 4 * B * L + 4 * stats * B * HEADS * L
    return _bound(nbytes, products * 2 * B * HEADS * L * L * (HD // HEADS) / BF16_OPS)


def bound_flash_forward(B, L, stats=False):
    # q, k, v read, o written (and m, l when the backward needs them); S and P V
    return _flash_bound(B, L, 4, 2 if stats else 0, 2)


def bound_flash_dkv(B, L):
    return _flash_bound(B, L, 6, 3, 4)  # q, k, v, do read, dk, dv written; m, l, di; S, dP, dV, dK


def bound_flash_dq(B, L):
    # q, k, v, o, do read, dq written; m, l read, di written (taken from o and do); S, dP, dQ
    return _flash_bound(B, L, 6, 3, 3)


def bound_shear(B, C, S, L, pad):
    # output column r reads rows s_r .. s_r + W of its plane: W + 1 of the S padded rows
    W = S - 2 * pad
    return _bound(4 * (B * C * (W + 1) * L + B * C * W * L + B * L), 3 * B * C * W * L / F32_OPS)


def bound_bn_stats(R, C, itemsize):
    return _bound(R * C * itemsize + 8 * C, 5 * R * C / F32_OPS)


def bound_bn_stats_backward(R, C, itemsize):
    # x read, dx written, mean, dmean, dvar read; x - mean, the product, the division, the sum
    return _bound(2 * R * C * itemsize + 12 * C, 4 * R * C / F32_OPS)


def bound_selective_scan(B, L, D, N):
    # x, dt read and y written (B, L, D); A (D, N); B, C (B, L, N); D_skip. A step
    # of one state: dt * A, exp, the decay product and the drive (2), the C product and sum (2)
    nbytes = 4 * (3 * B * L * D + D * N + 2 * B * L * N + D)
    return _bound(nbytes, 7 * B * L * D * N / F32_OPS)


# The bases of one (row, input) on 12 knots, order 3: 11 interval tests (3 operations
# each), then the 2 + 3 + 4 combinations that have a nonzero term (of the full
# recursion's 10 + 9 + 8; the rest are exactly 0), 9 operations each (4
# subtractions, 2 divisions, 2 products, 1 sum); silu 4
KAN_BASIS_OPS = 3 * 11 + 9 * (2 + 3 + 4) + 4
# the route kan_forward's products take (csrc/kan_spline.cu): 3xTF32 on the tensor cores
KAN_PRODUCT_ROUTE = "3xTF32: three TF32 products a multiply-add at 494.7 TFLOP/s dense"


def bound_kan_forward(E, B, IN, OUT, shared):
    # x read once (once for all experts when shared), grid, Wb, Ws (C = 8), y written;
    # the product 2 * (C + 1) a (row, input, output) as three TF32 products on the tensor
    # cores, beside the bases of each x once in float32 on the CUDA cores (the two units
    # run at once: the larger time counts)
    rows = B if shared else E * B
    nbytes = 4 * (rows * IN + E * IN * 12 + E * OUT * IN * 9 + E * B * OUT)
    return _bound(nbytes, max(3 * 2 * 9 * E * B * IN * OUT / TF32_OPS, KAN_BASIS_OPS * rows * IN / F32_OPS))


def _kan_products(x, grid, base_w, spline_w):
    """kan_forward's two products alone on torch.matmul, float32 with TF32 off, the
    bases made beforehand (timing only): the yardstick of its products, since no one
    PyTorch call computes the layer."""
    check(not torch.backends.cuda.matmul.allow_tf32, "the float32 yardstick needs allow_tf32 off")
    if base_w.dim() == 2:  # one layer: a bank of one
        grid, base_w, spline_w = grid[None], base_w[None], spline_w[None]
    E, OUT, IN = base_w.shape
    xs = x if x.dim() == 3 else x.expand(E, *x.shape)
    silu_x = F.silu(xs)
    bases = torch.stack([ks.b_splines(xe, ge, 3).reshape(xe.shape[0], -1) for xe, ge in zip(xs, grid)])
    wb, ws_ = base_w.transpose(1, 2), spline_w.reshape(E, OUT, -1).transpose(1, 2)
    return lambda: (torch.matmul(silu_x, wb), torch.matmul(bases, ws_))


# ---------------------------------------------------------------------------
def phase_device() -> tuple[torch.device, str]:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[dev.index]
    emit({"phase": "device", "name": torch.cuda.get_device_name(dev), "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__, "cuda": torch.version.cuda})
    return dev, smi


def _ptxas(log: str, fragments: tuple) -> dict:
    """Registers, stack and spills of each kernel whose mangled name holds one
    of ``fragments``, from the build's ``-Xptxas=-v`` log, and whether ptxas
    serialized its wgmma pipeline (C7515, "Potential Performance Loss").
    A kernel is named with its template arguments: attention_ablate_kernel<1,3>
    is one 64-column chunk, mode 3 of ops/attention_ablate.py::MODES (nopv);
    bn_stats_kernel<bf16,8> reads bf16 in 16-byte vectors."""
    def short(mangled):
        # the kernel's name: the last length-prefixed identifier ending in "_kernel", then
        # its integer template arguments, if any
        found = None
        for m in re.finditer(r"(?=(\d{1,2})([a-z]))", mangled):
            start = m.start() + len(m.group(1))
            name = mangled[start:start + int(m.group(1))]
            if name.endswith("_kernel") and re.fullmatch(r"[a-z][a-z_0-9]*", name):
                found = (start, name)
        if found is None:
            return mangled
        start, name = found
        k = re.match(r"I((?:Li\d+E|13__nv_bfloat16|f)+)E", mangled[start + len(name):])
        args = {"13__nv_bfloat16": "bf16", "f": "float"}
        return (f"{name}<{','.join(args.get(a, a[2:-1]) for a in re.findall(r'Li\d+E|13__nv_bfloat16|f', k.group(1)))}>"
                if k else name)

    def wanted(mangled):
        return any(f in mangled for f in fragments)

    out, name = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = short(m.group(1)) if wanted(m.group(1)) else None
            if name:
                out.setdefault(name, {})
        elif name and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                                      line)):
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
    for line in log.splitlines():
        if "C7515" in line and (m := re.search(r"function '(\w+)'", line)) and wanted(m.group(1)):
            out.setdefault(short(m.group(1)), {})["wgmma_serialized"] = True
    return out


def phase_build() -> None:
    path, seconds = _build.build()
    _build.load_library()
    emit({"phase": "build", "library": str(path.relative_to(_build.BUILD_DIR.parent.parent)),
          "seconds": seconds})
    # the attention kernels' ptxas report (the consumers run at setmaxnreg 240, the producer
    # at 24); the int8 FFN's s8 wgmma kernels (ffn_s8_*_kernel<act, tile width>) and the shear;
    # the int8 attention block's (attn_s8_qkv_kernel<tile width>, attn_s8_out_ln_kernel) and its
    # core, int8_attention_core_kernel<NC>, fused_attention_kernel<NC>'s code; the bf16 sublayers'
    # (bf16_tile_gemm_kernel<act + 1, tile width>, bf16_ln_gemm_kernel, the split's
    # bf16_partial_gemm_kernel and row passes, attention_block_core_kernel<NC>)
    log = Path(str(path) + ".log").read_text()
    emit({"phase": "build",
          "ptxas_attention": _ptxas(log, ("flash_", "fused_attention_kernel", "attention_ablate_kernel")),
          "ptxas_int8_ffn_and_shear": _ptxas(log, ("ffn_s8_", "ffn_row_scale_kernel", "shear_sublane_kernel")),
          "ptxas_int8_attention": _ptxas(log, ("attn_s8_", "int8_attention_core_kernel")),
          "ptxas_bf16_sublayers": _ptxas(log, ("bf16_tile_gemm_kernel", "bf16_ln_gemm_kernel", "bf16_partial_gemm_kernel",
                                               "bias_act_rows_kernel", "ln_rows_kernel",
                                               "attention_block_core_kernel")),
          "ptxas_kan_and_scan": _ptxas(log, ("kan_forward_kernel", "selective_scan_kernel")),
          "ptxas_bn_stats": _ptxas(log, ("bn_stats_kernel", "bn_stats_backward_kernel"))})


def _rand(rng, shape, scale, dev):
    return torch.tensor(rng.standard_normal(shape) * scale, dtype=torch.bfloat16, device=dev)


def _rand_f32(rng, shape, scale, dev, offset=0.0):
    return torch.tensor(offset + rng.standard_normal(shape) * scale, dtype=torch.float32, device=dev)


def _key_bias(B, L, n_pad, dev):
    mask = np.ones((B, L), np.float32)
    mask[:, L - n_pad:] = 0.0  # the last n_pad keys of each row are padding
    return torch.tensor((1.0 - mask) * -1e9, device=dev)


def _segment_ids(rng, B, L, dev):
    """int32 (B, L) attention masks as requests carry them (real prefixes of L/8 to L
    tokens), with one row mostly padding and one whose second segment's keys lie
    only in the last tile."""
    lengths = rng.integers(L // 8, L + 1, B)
    seg = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
    seg[0] = 1
    seg[1, 3:] = 0
    seg[2] = 0
    seg[2, L - 10:] = 1
    return torch.from_numpy(seg).to(dev)


def judge_bf16(out, ref):
    mx, mean = diff(out, ref)
    return mx, mean, MAX_ABS, mx <= MAX_ABS and mean < MEAN_ABS


def judge_flash(out, ref):
    """The flash forward with its statistics: o within the bf16 bound, m and l
    within atol 1e-3 and rtol 1e-4 (tests/test_torch_port_cuda.py)."""
    (o, m, l), (o_ref, m_ref, l_ref) = out, ref
    mx, mean, bound, ok = judge_bf16(o, o_ref)
    stats_ok = all(torch.allclose(a, b, atol=1e-3, rtol=1e-4) for a, b in ((m, m_ref), (l, l_ref)))
    return mx, mean, bound, ok and stats_ok


def judge_int8(out, ref):
    mx, mean = diff(out, ref)
    bound = INT8_FRAC * ref.float().abs().max().item()
    return mx, mean, bound, mx <= bound and mean < MEAN_ABS


def judge_f32(out, ref):
    mx, mean = diff(out, ref)
    bound = F32_FRAC * ref.float().abs().max().item()
    return mx, mean, bound, mx <= bound


def judge_grad(out, ref):
    """dQ, dK, dV: max |d| <= GRAD_FRAC * max |plain|, mean |d| <= GRAD_MEAN * max |plain|."""
    outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    mx = mean = bound = 0.0
    ok = True
    for o, r in zip(outs, refs):
        d_max, d_mean = diff(o, r)
        scale = r.float().abs().max().item()
        ok = ok and d_max <= GRAD_FRAC * scale and d_mean <= GRAD_MEAN * scale
        mx, mean, bound = max(mx, d_max), max(mean, d_mean), max(bound, GRAD_FRAC * scale)
    return mx, mean, bound, ok


def judge_dq(o, do):
    """The dQ kernel's (dq, di): dq as judge_grad; di within 2 D 2^-24 * sum |o * do| of
    its row (each bf16 product is exact in float32, so the sums differ only in order)."""
    bound = 2 * (HD // HEADS) * 2.0 ** -24 * fl.attention_di(o.abs(), do.abs(), HEADS)

    def judge(out, ref):
        mx, mean, max_bound, ok = judge_grad(out[0], ref[0])
        d = (out[1] - ref[1]).abs()
        ok = ok and out[1].dtype == torch.float32 and bool((d <= bound).all())
        return max(mx, d.max().item()), mean, max_bound, ok

    return judge


def judge_exact(out, ref):
    mx, mean = diff(out, ref)
    return mx, mean, 0.0, mx == 0.0


def judge_stats(x):
    """bn_stats' (mean, var) against the plain version's: rtol STATS_RTOL and
    atol STATS_ATOL * E|x| (mean) or * E[x^2] (variance), element by element."""
    xf = x.float()
    atols = (STATS_ATOL * xf.abs().mean().item(), STATS_ATOL * xf.square().mean().item())

    def judge(out, ref):
        ok, mx, mean, bound = True, 0.0, 0.0, 0.0
        for o, r, atol in zip(out, ref, atols):
            d = (o - r).abs()
            ok = ok and bool((d <= atol + STATS_RTOL * r.abs()).all())
            mx, mean = max(mx, d.max().item()), max(mean, d.mean().item())
            bound = max(bound, atol + STATS_RTOL * r.abs().max().item())
        return mx, mean, bound, ok

    return judge


def judge_bf16_ulp(out, ref):
    """Each element within one bf16 ulp of the larger of the two (bn_stats' gradient:
    the same float32 arithmetic, one rounding to bf16)."""
    a = torch.maximum(out.float().abs(), ref.float().abs()).clamp(min=torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(a)) - 7)
    d = (out.float() - ref.float()).abs()
    return d.max().item(), d.mean().item(), ulp.max().item(), bool((d <= ulp).all())


def _shear_case(rng, B, pad, max_degrees, axis, dev):
    """A shear_sublane input as rotate_3shear makes it: (B, 3, 224 + 2 pad, 224)
    with a zero border, and d = tan(angle / 2) * idx (the W shears) or
    -sin(angle) * idx (the H shear)."""
    O = 224
    x = torch.zeros((B, 3, O + 2 * pad, O), dtype=torch.float32)
    x[:, :, pad:pad + O] = torch.from_numpy(rng.random((B, 3, O, O), dtype=np.float32))
    ang = np.radians(rng.uniform(-max_degrees, max_degrees, (B, 1)))
    slope = np.tan(ang / 2) if axis == "w" else -np.sin(ang)
    d = (slope * (np.arange(O) - (O - 1) / 2.0)).astype(np.float32)
    x, d = x.to(dev), torch.from_numpy(d).to(dev)
    # the same function as one grid_sample call: column r exactly, row v + pad + d[r] (timing only)
    S = O + 2 * pad
    cols = (2.0 * torch.arange(O, device=dev) / (O - 1) - 1.0).expand(B, O, O)
    rows = 2.0 * (torch.arange(O, device=dev)[None, :, None] + pad + d[:, None, :]) / (S - 1) - 1.0
    grid = torch.stack([cols, rows], dim=-1)
    library = lambda: F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=True)  # noqa: E731
    return (x, d, pad), library


def _sdpa_calls(q, k, v, seg, do):
    """SDPA's forward with the boolean segment mask, and its backward alone:
    autograd.grad through one saved forward graph (timing only)."""
    B, L, _ = q.shape
    heads = [t.view(B, L, HEADS, HD // HEADS).transpose(1, 2) for t in (q, k, v)]
    keep = (seg[:, :, None] == seg[:, None, :])[:, None]
    leaves = [t.detach().requires_grad_() for t in heads]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=keep, scale=0.125)
    do_heads = do.view(B, L, HEADS, HD // HEADS).transpose(1, 2)
    forward = lambda: F.scaled_dot_product_attention(*heads, attn_mask=keep, scale=0.125)  # noqa: E731
    backward = lambda: torch.autograd.grad(out, leaves, do_heads, retain_graph=True)  # noqa: E731
    return forward, backward


def _kernel_cases(dev, rng, seed):
    """(name, shape, plain, args, main path?, (bound_ms, bound_by), library call or None, judge)."""
    cases = []
    # batch 1 (the p50 metric's sublayer, on the split plan) draws from a generator of its own, so the
    # cases and phases after it get the inputs they got before it was added
    for B, L, g in ((1, SEQ, np.random.default_rng([seed, 1, SEQ])), (8, 128, rng), (8, 256, rng),
                    (BATCH, SEQ, rng)):
        args = (_rand(g, (B, L, HD), 1.0, dev), _rand(g, (3 * HD, HD), 0.03, dev),
                _rand(g, (3 * HD,), 0.01, dev), _rand(g, (HD, HD), 0.03, dev), _rand(g, (HD,), 0.01, dev),
                (1.0 + _rand(g, (HD,), 0.1, dev)).contiguous(), _rand(g, (HD,), 0.1, dev),
                _key_bias(B, L, 28, dev), HEADS, 0.125, 1e-12)
        cases.append(("attention_block", f"B={B},L={L}", ab.attention_block_reference, args,
                      (B, L) == (BATCH, SEQ), bound_attention_block(B, L), None, judge_bf16))
    for N in (128, BATCH * SEQ):
        for act in ("erf", "tanh"):
            args = (_rand(rng, (N, HD), 1.0, dev), _rand(rng, (DI, HD), 0.03, dev),
                    _rand(rng, (DI,), 0.01, dev), _rand(rng, (HD, DI), 0.03, dev),
                    _rand(rng, (HD,), 0.01, dev), (1.0 + _rand(rng, (HD,), 0.1, dev)).contiguous(),
                    _rand(rng, (HD,), 0.1, dev), 1e-12, act)
            cases.append(("ffn_block", f"N={N},act={act}", fb.ffn_block_reference, args,
                          (N, act) == (BATCH * SEQ, "erf"), bound_ffn_block(N), None, judge_bf16))
    P = MIBF_HAM_SERVING.batch_size
    for N in (128, P * SEQ):
        for act in ("erf", "tanh"):  # the preset's fast_math takes tanh
            w1, s1 = quantize_weight(_rand(rng, (DI, HD), 0.03, dev))
            w2, s2 = quantize_weight(_rand(rng, (HD, DI), 0.03, dev))
            args = (_rand(rng, (N, HD), 1.0, dev), w1, s1, _rand_f32(rng, (DI,), 0.01, dev), w2, s2,
                    _rand_f32(rng, (HD,), 0.01, dev), _rand_f32(rng, (HD,), 0.1, dev, 1.0),
                    _rand_f32(rng, (HD,), 0.1, dev), 1e-12, act)
            cases.append(("int8_ffn_block", f"N={N},act={act}", qk.int8_ffn_block_reference, args,
                          (N, act) == (P * SEQ, "tanh"), bound_int8_ffn_block(N), None, judge_int8))
    # the preset at seq 128 and at its own 256; the 256 case draws from a generator of its own, so
    # the cases and phases after it get the inputs they got before it was added
    for B, L, g in ((8, 128, rng), (8, LONG_SEQ, rng), (P, SEQ, rng),
                    (P, LONG_SEQ, np.random.default_rng([seed, P, LONG_SEQ]))):
        wqkv, sqkv = quantize_weight(_rand(g, (3 * HD, HD), 0.03, dev))
        wo, so = quantize_weight(_rand(g, (HD, HD), 0.03, dev))
        args = (_rand(g, (B, L, HD), 1.0, dev), wqkv, sqkv, _rand_f32(g, (3 * HD,), 0.01, dev), wo, so,
                _rand_f32(g, (HD,), 0.01, dev), _rand_f32(g, (HD,), 0.1, dev, 1.0),
                _rand_f32(g, (HD,), 0.1, dev), _key_bias(B, L, 28, dev), HEADS, 0.125, 1e-12)
        cases.append(("int8_attention_block", f"B={B},L={L}", qk.int8_attention_block_reference, args,
                      (B, L) == (P, SEQ), bound_int8_attention_block(B, L), None, judge_int8))
    for B, L in ((8, 384), (8, 500), (8, SEQ512), (BATCH, SEQ512)):
        q, k, v = (_rand(rng, (B, L, HD), 1.0, dev) for _ in range(3))
        bias = _key_bias(B, L, L // 5, dev)
        args = (q, k, v, bias, HEADS, 0.125)
        heads = [t.view(B, L, HEADS, HD // HEADS).transpose(1, 2) for t in (q, k, v)]
        keep = (bias == 0)[:, None, None, :]
        library = lambda h=heads, m=keep: F.scaled_dot_product_attention(*h, attn_mask=m, scale=0.125)  # noqa: E731
        cases.append(("fused_attention", f"B={B},L={L}", fa.attention_reference, args,
                      (B, L) == (BATCH, SEQ512), bound_fused_attention(B, L), library, judge_bf16))
    # BERT's flash core: the forward at the flash serving shape (batch 32, seq 512), a ragged seq
    # 200 and the training shape (32, 256) with the statistics the backward reads, the two backward
    # kernels at both full shapes. The library call is SDPA with the boolean segment mask: its
    # forward for the forward, and for each backward kernel SDPA's backward alone (autograd.grad on
    # a saved forward graph), which makes dQ, dK and dV together: one yardstick for the pair
    for B, L, kinds in ((8, 200, ("forward",)), (BATCH, SEQ512, ("forward", "dkv", "dq")),
                        (BATCH, LONG_SEQ, ("forward", "dkv", "dq"))):
        q, k, v, do = (_rand(rng, (B, L, HD), 1.0, dev) for _ in range(4))
        seg = _segment_ids(rng, B, L, dev)
        o, m, l = fl.flash_attention_reference(q, k, v, seg, HEADS, 0.125, save_stats=True)
        dkv_args = (q, k, v, seg, m, l, do, fl.attention_di(o, do, HEADS), HEADS, 0.125)
        dq_args = (q, k, v, seg, o, m, l, do, HEADS, 0.125)
        sdpa, sdpa_backward = _sdpa_calls(q, k, v, seg, do)
        stats = (B, L) == (BATCH, LONG_SEQ)  # the training step's forward saves m and l
        for kind in kinds:
            if kind == "forward":
                cases.append(("flash_attention", f"B={B},L={L}" + (",stats" if stats else ""),
                              fl.flash_attention_reference, (q, k, v, seg, HEADS, 0.125, stats),
                              (B, L) == (BATCH, SEQ512), bound_flash_forward(B, L, stats), sdpa,
                              judge_flash if stats else judge_bf16))
            elif kind == "dkv":
                cases.append(("flash_attention_bwd_dkv", f"B={B},L={L}", fl.flash_attention_bwd_dkv_reference,
                              dkv_args, (B, L) == (BATCH, LONG_SEQ), bound_flash_dkv(B, L), sdpa_backward,
                              judge_grad))
            else:
                cases.append(("flash_attention_bwd_dq", f"B={B},L={L}", fl.flash_attention_bwd_dq_reference,
                              dq_args, (B, L) == (BATCH, LONG_SEQ), bound_flash_dq(B, L), sdpa_backward,
                              judge_dq(o, do)))
    # the training step's rotation: pads 17 (W shears) and 31 (H shear) at MIBF's 15 degrees, and
    # 49 / 82 at 45 degrees, ConNexT's at batch 32 and the baseline family's at batch 64 (inputs of
    # their own, so that the cases after them keep theirs)
    b64 = np.random.default_rng([seed, 64])
    b320 = np.random.default_rng([seed, 320])  # the Spine sequence's 64 x 5 slices, a batch of 320
    for B, pad, deg, axis, r in ((BATCH, 17, 15.0, "w", rng), (BATCH, 31, 15.0, "h", rng),
                                 (BATCH, 49, 45.0, "w", rng), (BATCH, 82, 45.0, "h", rng),
                                 (BASELINE_BATCH, 49, 45.0, "w", b64), (BASELINE_BATCH, 82, 45.0, "h", b64),
                                 (SPINE_BATCH * SPINE_T, 49, 45.0, "w", b320),
                                 (SPINE_BATCH * SPINE_T, 82, 45.0, "h", b320)):
        args, library = _shear_case(r, B, pad, deg, axis, dev)
        x = args[0]
        cases.append(("shear_sublane", f"x={tuple(x.shape)},pad={pad}", sh.shear_reference, args, pad == 17,
                      bound_shear(*x.shape, pad), library, judge_exact))
    # ResNet50's 12 distinct BatchNorm inputs at batch 32, channels-last rows, bf16: the stem, layer1's
    # bn3, layer4's bn3 first (the parent's three), then the rest
    for R, C in RESNET50_BN_B32:
        x = (torch.randn((R, C), device=dev, generator=torch.Generator(device=dev).manual_seed(R + C)) * 2.0
             + 0.5).to(torch.bfloat16)
        library = lambda x=x: torch.var_mean(x, dim=0, unbiased=False)  # noqa: E731
        stem = (R, C) == RESNET50_BN_B32[0]
        cases.append(("bn_stats", f"R={R},C={C},bf16", bns.bn_stats_reference, (x,), stem,
                      bound_bn_stats(R, C, 2), library, judge_stats(x)))
        # the gradient at x's own mean, the upstream gradients drawn (no one PyTorch call computes it)
        g = torch.Generator(device=dev).manual_seed(C)
        grads = [torch.randn(C, device=dev, generator=g) for _ in range(2)]
        cases.append(("bn_stats_backward", f"R={R},C={C},bf16", bns.bn_stats_backward_reference,
                      (x, bns.bn_stats_reference(x)[0], *grads), stem, bound_bn_stats_backward(R, C, 2), None,
                      judge_bf16_ulp))
    # the Mamba fusion's scan at batch 64: 49 layer4 tokens, d_inner 512, N 16; and the
    # gate's other state sizes (MambaVision's N 8, the multimodal Mamba fusion's N 128); then the vmamba
    # fusion's two scans, 49 layer4 tokens projected to 32, d_inner 64, N 16, from a generator of its
    # own, so the cases and phases after it get the inputs they got before it was added
    for B, L, D, N, g in ((BASELINE_BATCH, 49, 512, 16, rng), (BASELINE_BATCH, 196, 320, 8, rng),
                          (16, 64, 512, 128, rng), (BASELINE_BATCH, 49, 64, 16, np.random.default_rng([seed, 64]))):
        f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
        args = (f(g.standard_normal((B, L, D))), f(np.log1p(np.exp(g.standard_normal((B, L, D)) - 2.0))),
                -torch.arange(1, N + 1, dtype=torch.float32, device=dev).expand(D, N).contiguous(),
                f(g.standard_normal((B, L, N))), f(g.standard_normal((B, L, N))), f(np.ones(D)))
        cases.append(("selective_scan", f"B={B},L={L},D={D},N={N}", ss.selective_scan_reference, args,
                      (D, N) == (512, 16), bound_selective_scan(B, L, D, N), None, judge_f32))
    # the MoE head's KAN bank at batch 64: 4 experts, layer 0 (256 -> 1024, x shared) and layer 1 (1024 -> 7)
    E, H = HAM_HEAD_MOE.moe_num_experts, HAM_HEAD_MOE.hidden_dim
    for IN, OUT, shared in ((H, 4 * H, True), (4 * H, HAM_HEAD_MOE.num_classes, False)):
        f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
        x = f(rng.standard_normal((BASELINE_BATCH, IN) if shared else (E, BASELINE_BATCH, IN)) * 0.7)
        args = (x, make_grid(IN, 5, 3, device=dev).expand(E, IN, 12).contiguous(),
                f(rng.uniform(-1, 1, (E, OUT, IN)) / np.sqrt(IN)), f(rng.standard_normal((E, OUT, IN, 8)) * 0.01))
        cases.append(("kan_forward", f"E={E},x={tuple(x.shape)},OUT={OUT}", ks.kan_forward_reference, args, shared,
                      bound_kan_forward(E, BASELINE_BATCH, IN, OUT, shared), None, judge_f32))
    # ConNexT's MoE bank at batch 32 (configs/connext/connext_ham.yml): 4 experts, [768, 512, 128, 32, 7],
    # layer 0's x shared; a generator of its own, so the cases and phases after it get the inputs they got
    # before it was added
    g = np.random.default_rng([seed, CONNEXT_SEQ])
    E = CONNEXT_HAM.moe_num_experts
    for i, (IN, OUT) in enumerate(zip(CONNEXT_BANK, CONNEXT_BANK[1:])):
        f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
        x = f(g.standard_normal((CONNEXT_BATCH, IN) if i == 0 else (E, CONNEXT_BATCH, IN)) * 0.7)
        args = (x, make_grid(IN, 5, 3, device=dev).expand(E, IN, 12).contiguous(),
                f(g.uniform(-1, 1, (E, OUT, IN)) / np.sqrt(IN)), f(g.standard_normal((E, OUT, IN, 8)) * 0.01))
        cases.append(("kan_forward", f"E={E},x={tuple(x.shape)},OUT={OUT}", ks.kan_forward_reference, args, False,
                      bound_kan_forward(E, CONNEXT_BATCH, IN, OUT, i == 0), None, judge_f32))
    # the Mamba slice (a generator of its own): MambaVision-T's stage-3 and stage-4 mixers at batch 64
    # (d_inner 160 over 196 tokens, 320 over 49, N 8), ConNexT's fusion Mamba at batch 32 (52 tokens,
    # d_inner 512, N 128), and the fusion's KAN attention q / k / v: one layer (E 1), 1,664 rows, 256 -> 256
    g = np.random.default_rng([seed, 23])
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    for B, L, D, N in ((BASELINE_BATCH, 196, 160, 8), (BASELINE_BATCH, 49, 320, 8), (CONNEXT_BATCH, 52, 512, 128)):
        args = (f(g.standard_normal((B, L, D))), f(np.log1p(np.exp(g.standard_normal((B, L, D)) - 2.0))),
                -torch.arange(1, N + 1, dtype=torch.float32, device=dev).expand(D, N).contiguous(),
                f(g.standard_normal((B, L, N))), f(g.standard_normal((B, L, N))), f(np.ones(D)))
        cases.append(("selective_scan", f"B={B},L={L},D={D},N={N}", ss.selective_scan_reference, args, False,
                      bound_selective_scan(B, L, D, N), None, judge_f32))
    rows, IN = CONNEXT_BATCH * 52, 256
    args = (f(g.standard_normal((rows, IN)) * 0.7), make_grid(IN, 5, 3, device=dev),
            f(g.uniform(-1, 1, (IN, IN)) / np.sqrt(IN)), f(g.standard_normal((IN, IN, 8)) * 0.01))
    cases.append(("kan_forward", f"E=1,x={(rows, IN)},OUT={IN}", ks.kan_forward_reference, args, False,
                  bound_kan_forward(1, rows, IN, IN, False), None, judge_f32))
    return cases


def _flash_backward_pair(dev, rng) -> None:
    """The port's whole flash backward (FlashAttention.backward: dQ, which takes
    di, then dK/dV) against SDPA's backward alone at the training shape (32, 256)
    and at seq 512, device time of each by the profiler (timing only). The
    parent's line timed di (attention_di, torch), dK/dV and dQ; di is inside dQ
    now, so the whole backward is the same work, and attention_di's own device
    time is printed beside it."""
    for B, L in ((BATCH, LONG_SEQ), (BATCH, SEQ512)):
        q, k, v, do = (_rand(rng, (B, L, HD), 1.0, dev) for _ in range(4))
        seg = _segment_ids(rng, B, L, dev)
        o, m, l = fl.flash_attention_forward(q, k, v, seg, HEADS, 0.125, save_stats=True)

        def port():
            _, di = fl.flash_attention_bwd_dq(q, k, v, seg, o, m, l, do, HEADS, 0.125)
            fl.flash_attention_bwd_dkv(q, k, v, seg, m, l, do, di, HEADS, 0.125)

        _, sdpa_backward = _sdpa_calls(q, k, v, seg, do)
        emit({"phase": "kernels", "kernel": "flash_attention backward (dQ with di + dK/dV)",
              "parent_definition": "di (attention_di, torch) + dK/dV + dQ", "shape": f"B={B},L={L}",
              "ms": cuda_ms(port), "device_ms": kernel_device_ms(port),
              "attention_di_device_ms": kernel_device_ms(lambda: fl.attention_di(o, do, HEADS)),
              "bound_ms": bound_flash_dkv(B, L)[0] + bound_flash_dq(B, L)[0], "library_ms": cuda_ms(sdpa_backward),
              "library_device_ms": kernel_device_ms(sdpa_backward), "library": "SDPA backward alone"})


def phase_kernels(dev, rng, seed: int) -> dict:
    """Each kernel against its plain version; returns per-kernel summaries."""
    summary = {}
    for name, shape, plain, args, main_path, (bound_ms, bound_by), library, judge in _kernel_cases(dev, rng, seed):
        kernel = KERNELS[name][0]
        out = kernel(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        outs = out if isinstance(out, tuple) else (out,)
        check(all(bool(torch.isfinite(o.float()).all()) for o in outs), f"{name} {shape}: non-finite output")
        mx, mean, max_bound, ok = judge(out, ref)
        check(ok, f"{name} {shape}: max|d|={mx} mean|d|={mean} beyond {max_bound}")
        ms, plain_ms = cuda_ms(lambda: kernel(*args)), cuda_ms(lambda: plain(*args))
        library_ms = cuda_ms(library) if library is not None else None
        device_ms = kernel_device_ms(lambda: kernel(*args))
        library_device_ms = kernel_device_ms(library) if library is not None else None
        line = {"phase": "kernels", "kernel": name, "shape": shape, "max_abs_err": mx, "mean_abs_err": mean,
                "max_abs_bound": max_bound, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                "library_device_ms": library_device_ms}
        if name == "int8_attention_block":
            line["device_ms_by_stage"] = int8_attention_stages(lambda: kernel(*args))
        if name == "attention_block":
            line["device_ms_by_stage"] = attention_block_stages(lambda: kernel(*args))
        if name in ("attention_block", "ffn_block"):
            products = _sublayer_products(name, args)
            line.update(gemm_library="torch.matmul (cuBLAS) of the sublayer's two products alone",
                        gemm_library_ms=cuda_ms(products), gemm_library_device_ms=kernel_device_ms(products))
        if name == "kan_forward":
            products = _kan_products(*args)
            line.update(bound_rate=KAN_PRODUCT_ROUTE,
                        gemm_library="torch.matmul of the layer's two products alone, float32, TF32 off, "
                                     "the bases made beforehand",
                        gemm_library_ms=cuda_ms(products), gemm_library_device_ms=kernel_device_ms(products))
            summary.setdefault("kan_forward_layers", []).append(
                {"in_out": list(args[2].shape[:-3:-1])}
                | {k: line[k] for k in ("shape", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                        "gemm_library_ms", "gemm_library_device_ms")})
        emit(line)
        s = summary.setdefault(name, {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], mx)
        if main_path:
            s.update(shape=shape, ms=ms, device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=library_ms, library_device_ms=library_device_ms)
        del out, ref
    _flash_backward_pair(dev, rng)
    # bn_stats' backward (the analytic VJP) against autograd through the plain version,
    # float32 at layer1's bn3 input
    x0 = torch.randn((BATCH * 56 * 56, 256), device=dev, generator=torch.Generator(device=dev).manual_seed(3))
    w = torch.randn(256, device=dev, generator=torch.Generator(device=dev).manual_seed(4))
    grads = []
    for fn in (bns.bn_stats, bns.bn_stats_reference):
        x = x0.clone().requires_grad_()
        m, v = fn(x)
        (torch.sum(w * m) + torch.sum(torch.sqrt(v + 1e-5))).backward()
        grads.append(x.grad)
    d = (grads[0] - grads[1]).abs()
    scale = grads[1].abs().max().item()
    check(bool((d <= 1e-5 * scale + 1e-4 * grads[1].abs()).all()), f"bn_stats backward: max|d|={d.max().item()}")
    emit({"phase": "kernels", "kernel": "bn_stats", "shape": f"backward R={x0.shape[0]},C=256,f32",
          "max_abs_err": d.max().item(), "max_abs_bound": 1e-5 * scale})
    del x0, grads, d
    torch.cuda.empty_cache()
    return summary


def judge_rel(out, ref, mode):
    """An ablated mode against its plain version. nopv writes bf16 probabilities
    rounded as the plain version rounds them: each within one bf16 ulp of its own,
    |d| <= 2^-7 |p| + 2^-24. The others: the bf16 bound on |d| over each (batch,
    query) row's own max(1, max |plain|), since nosmax's outputs reach 1e10 in a
    row with padded keys and about 10 in a row without. Returns max |d|, and the
    worst share of its bound and the mean of |d| over the row scale beside the
    bf16 mean bound."""
    o, r = out.float(), ref.float()
    d = (o - r).abs()
    if mode == "nopv":
        used = (d / (2.0 ** -7 * r.abs() + 2.0 ** -24)).max().item()
        return {"max_abs": d.max().item(), "bound_used": used}, used <= 1.0
    rel = d / r.abs().amax(-1, keepdim=True).clamp_min(1.0)
    used, mean = rel.max().item() / MAX_ABS, rel.mean().item()
    return {"max_abs": d.max().item(), "bound_used": used, "mean_row_rel": mean}, used <= 1.0 and mean < MEAN_ABS


def phase_ablate(dev, rng) -> tuple[dict, int]:
    """The attention ablation at the TPU script's shape (B 256, L 128, 12 heads
    of 64): each mode's kernel against its plain version, with zero bias (the
    diagnostic's) and with a bias that pads keys in the even rows and is finite
    noise in the odd ones (judge_rel); full against fused_attention and aligned
    against full, bit for bit; each mode's times and bound on the zero bias. Then the main path, the diagnostic's own chains (diagnostics/
    attention_ablate.py::run), between zero_counts and read_counts: the count is
    the wrapper's calls, each chain's warm-up and capture and its profiled eager
    run (a graph replay launches the captured kernels without the wrapper).
    Returns full's summary for the kernels line and the main path's launches."""
    B, L, D, scale = diag.B, diag.L, HD // HEADS, diag.SCALE
    q, k, v = (_rand(rng, (B, L, HD), 1.0, dev) for _ in range(3))
    zero = torch.zeros((B, L), dtype=torch.float32, device=dev)
    mixed = _key_bias(B, L, 28, dev)  # even rows: the last 28 keys padded; odd rows: a finite N(0, 1) bias
    mixed[1::2] = torch.tensor(np.random.default_rng(1).standard_normal((B // 2, L)), device=dev)
    biases = {"zero": zero, "padding_and_noise": mixed}
    full = {name: fa.fused_attention(q, k, v, bias, HEADS, scale) for name, bias in biases.items()}
    summary = None
    for mode in aa.MODES:
        cols = slice(0, D) if mode == "aligned" else slice(None)  # aligned writes head 0's D columns only
        errs = {}
        for name, bias in biases.items():
            args = (q, k, v, bias, HEADS, scale, mode)
            out = aa.attention_ablate(*args)
            torch.cuda.synchronize()
            errs[name], ok = judge_rel(out[..., cols], aa.attention_ablate_reference(*args)[..., cols], mode)
            check(ok and bool(torch.isfinite(out[..., cols].float()).all()),
                  f"attention_ablate {mode} {name}: {errs[name]} beyond its bound")
            if mode == "full":
                check(torch.equal(out, full[name]), f"attention_ablate full {name}: not fused_attention's bits")
            if mode == "aligned":
                check(torch.equal(out[..., :D], full[name][..., :D]), f"aligned {name}: not full's first head")
        args = (q, k, v, zero, HEADS, scale, mode)
        kernel = lambda a=args: aa.attention_ablate(*a)  # noqa: E731
        library = None
        if mode == "full":  # SDPA with the key mask, as fused_attention's row times it
            heads = [t.view(B, L, HEADS, D).transpose(1, 2) for t in (q, k, v)]
            keep = (zero == 0)[:, None, None, :]
            library = lambda: F.scaled_dot_product_attention(*heads, attn_mask=keep, scale=scale)  # noqa: E731
        bound_ms, bound_by = bound_attention_ablate(mode, B, L)
        row = {"ms": cuda_ms(kernel), "device_ms": kernel_device_ms(kernel),
               "plain_ms": cuda_ms(lambda a=args: aa.attention_ablate_reference(*a), reps=5),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": cuda_ms(library) if library else None,
               "library_device_ms": kernel_device_ms(library) if library else None}
        emit({"phase": "ablate", "mode": mode, "shape": f"B={B},L={L},{HEADS}x{D}", "vs_plain": errs, **row})
        if mode == "full":
            summary = {"max_abs_err": errs["zero"]["max_abs"], **row}
    del full
    # --- the main path: the diagnostic's chains of K_STEPS calls, one CUDA graph a mode
    zero_counts()
    chains = diag.run(q, k, v, zero, HEADS)
    launches = read_counts()
    check(launches["attention_ablate"] > 0 and launches == {**dict.fromkeys(KERNELS, 0),
                                                            "attention_ablate": launches["attention_ablate"]},
          f"ablation chain launches {launches}")
    for row in chains:
        check(row["mode"] == "aligned" or bool(np.isfinite(row["chain_value"])), f"ablation chain {row}")
    emit({"phase": "ablate", "chain": chains, "k_steps": diag.K_STEPS, "launches": launches["attention_ablate"]})
    del q, k, v
    torch.cuda.empty_cache()
    return summary, launches["attention_ablate"]


def _request(rng, n, seq):
    lengths = rng.integers(seq // 8, seq + 1, n)
    lengths[: max(1, n // 4)] = seq  # some rows unpadded, the rest padded
    mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int64)
    ids = rng.integers(1000, VOCAB, (n, seq)) * mask
    ids[:, 0] = 101  # [CLS]
    return {"image": rng.integers(0, 256, (n, CANVAS, CANVAS, 3), dtype=np.uint8),
            "input_ids": ids.astype(np.int64), "attention_mask": mask}


def _bert_out(model, req, dev):
    with torch.inference_mode():
        return model.text_encoder(torch.from_numpy(req["input_ids"]).to(dev),
                                  torch.from_numpy(req["attention_mask"]).to(dev))[0]


def _twin(model, cfg, labels, dev):
    """A model of config ``cfg`` holding ``model``'s weights, in eval mode."""
    twin = MIBFNet(labels, cfg, device=dev, dtype=torch.bfloat16)
    twin.load_state_dict(model.state_dict())
    return twin.eval()


def sync_free(model, request, dev) -> bool:
    """One warm forward of a served path, from device-resident inputs through the
    eval preprocessing, under torch.cuda.set_sync_debug_mode("error"): any call in
    it that makes the host wait on the device raises."""
    inputs = [torch.from_numpy(request[k]).to(dev) for k in ("image", "input_ids", "attention_mask")]

    def forward():
        images = eval_pipeline(inputs[0], 224, normalize=model.normalize_input, dtype=model.input_dtype)
        return model(images, inputs[1], inputs[2])

    return sync_free_call(forward)


def sync_free_call(forward) -> bool:
    """``forward()`` once warm, then again under torch.cuda.set_sync_debug_mode("error")."""
    with torch.inference_mode():
        forward()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            forward()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return True


def _stream_rate(server, requests, n_requests) -> float:
    """images/s of predict_stream (depth 2) over n_requests, host clock."""
    stream = [requests[i % len(requests)] for i in range(n_requests)]
    list(server.predict_stream(iter(stream[:3]), depth=2))  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = 0
    for out in server.predict_stream(iter(stream), depth=2):
        rows += out.shape[0]
    return rows / (time.perf_counter() - t0)


def _p50_ms(model, request, dev) -> float:
    one = ServingModel(model, 1, dev)
    single = [{k: v[i:i + 1] for k, v in request.items()} for i in range(8)]
    for r in single[:3]:
        one.predict(r)
    lat = []
    for i in range(20):
        t0 = time.perf_counter()
        one.predict(single[i % len(single)])
        lat.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(lat)


def phase_slice(dev, rng, seed: int):
    cfg = BertConfig()  # BERT-base: 12 layers, 768 wide, 12 heads, 3072 inner, vocab 30522
    g = torch.Generator(device=dev).manual_seed(seed)
    model = init_parameters(MIBFNet(LABELS, cfg, device=dev, dtype=torch.bfloat16), g)
    server = ServingModel(model, BATCH, dev)
    requests = [_request(rng, n, SEQ) for n in (BATCH, BATCH, 5)]

    # --- the main path: three requests through predict_stream --------------
    zero_counts()
    outs = list(server.predict_stream(iter(requests), depth=2))
    launches = read_counts()
    expect = cfg.num_hidden_layers * len(requests)
    check(launches == {**dict.fromkeys(KERNELS, 0), "attention_block": expect, "ffn_block": expect},
          f"kernel launches {launches}, expected {expect} of attention_block and ffn_block (12 per forward)")
    for req, out in zip(requests, outs):
        n = req["image"].shape[0]
        check(out.shape == (n, LABELS), f"logits shape {out.shape}, expected {(n, LABELS)}")
        check(bool(np.isfinite(out).all()), "non-finite logits")

    # --- the same weights on the plain path --------------------------------
    plain = _twin(model, dataclasses.replace(cfg, attention_impl="xla"), LABELS, dev)
    plain_server = ServingModel(plain, BATCH, dev)
    logit_d = [diff(torch.from_numpy(o), torch.from_numpy(plain_server.predict(r)))
               for o, r in zip(outs, requests)]
    bert_d = diff(_bert_out(server.model, requests[0], dev), _bert_out(plain, requests[0], dev))
    check(bert_d[0] <= SLICE_ATOL and bert_d[1] < SLICE_MEAN, f"BERT output fused vs plain: {bert_d}")
    lmax, lmean = max(d[0] for d in logit_d), max(d[1] for d in logit_d)
    check(lmax <= SLICE_ATOL and lmean < SLICE_MEAN, f"logits fused vs plain: max {lmax} mean {lmean}")

    # --- one request at seq 256 (configs/mibf/mibf_ham.yml) -----------------
    long_req = _request(rng, 8, LONG_SEQ)
    zero_counts()
    long_out = ServingModel(model, 8, dev).predict(long_req)
    check(read_counts() == {**dict.fromkeys(KERNELS, 0), "attention_block": 12, "ffn_block": 12},
          f"seq-256 forward launches {read_counts()}, expected 12 of attention_block and ffn_block")
    check(long_out.shape == (8, LABELS) and bool(np.isfinite(long_out).all()), "seq-256 logits")
    long_bert_d = diff(_bert_out(server.model, long_req, dev), _bert_out(plain, long_req, dev))
    check(long_bert_d[0] <= SLICE_ATOL and long_bert_d[1] < SLICE_MEAN,
          f"seq-256 BERT output fused vs plain: {long_bert_d}")

    # --- end-to-end rates, host clock around synchronised work ---------------
    images_per_s = _stream_rate(server, requests[:2], 24)
    p50 = _p50_ms(model, requests[0], dev)

    # --- per-layer device times: towers, both BERT paths, kernel breakdown ---
    r = requests[0]
    towers = {}
    with torch.inference_mode():
        img = eval_pipeline(torch.from_numpy(r["image"]).to(dev), 224, normalize=False, dtype=torch.bfloat16)
        ids = torch.from_numpy(r["input_ids"]).to(dev)
        mask = torch.from_numpy(r["attention_mask"]).to(dev)
        for b in (BATCH, 1):
            fwd = lambda: server.model(img[:b], ids[:b], mask[:b])  # noqa: E731
            towers[f"b{b}"] = {
                "resnet_tower_ms": cuda_ms(lambda: server.model.image_encoder(img[:b]), reps=10),
                "bert_tower_ms": cuda_ms(lambda: server.model.text_encoder(ids[:b], mask[:b]), reps=10),
                "bert_tower_plain_ms": cuda_ms(lambda: plain.text_encoder(ids[:b], mask[:b]), reps=10),
                "forward_ms": cuda_ms(fwd, reps=10),
                "forward_plain_ms": cuda_ms(lambda: plain(img[:b], ids[:b], mask[:b]), reps=10),
            }
            towers[f"b{b}"]["device"] = device_profile(fwd, towers[f"b{b}"]["forward_ms"])

    emit({"phase": "slice", "model": "MIBFNet(num_labels=7): ResNet50 + BERT-base, bf16",
          "requests": [int(q["image"].shape[0]) for q in requests], "launches": launches,
          "sync_free": sync_free(server.model, requests[0], dev),
          "logits_vs_plain": {"max_abs": lmax, "mean_abs": lmean},
          "bert_out_vs_plain": {"max_abs": bert_d[0], "mean_abs": bert_d[1]},
          "seq256_bert_out_vs_plain": {"max_abs": long_bert_d[0], "mean_abs": long_bert_d[1]},
          "images_per_s_b32_stream": images_per_s, "p50_latency_ms_b1": p50, "towers": towers})
    return launches, model, plain


def _composite_ms(fn) -> float:
    with int8_composite():
        return cuda_ms(fn, reps=5)


def phase_preset(dev, rng, seed: int) -> dict:
    preset = MIBF_HAM_SERVING  # fast_math + int8 BERT-base, batch 512, seq 256, 7 labels
    cfg, P = preset.bert, preset.batch_size
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    model = init_parameters(MIBFNet(preset.num_labels, cfg, device=dev, dtype=torch.bfloat16), g)
    server = ServingModel(model, P, dev)
    requests = [_request(rng, n, SEQ) for n in (P, P, 77)]

    # --- the main path: three requests through predict_stream --------------
    zero_counts()
    outs = list(server.predict_stream(iter(requests), depth=2))
    launches = read_counts()
    expect = cfg.num_hidden_layers * len(requests)
    check(launches == {**dict.fromkeys(KERNELS, 0), "int8_attention_block": expect, "int8_ffn_block": expect},
          f"preset launches {launches}, expected {expect} of each int8 kernel and no other (12 per forward)")
    for req, out in zip(requests, outs):
        n = req["image"].shape[0]
        check(out.shape == (n, preset.num_labels) and bool(np.isfinite(out).all()), f"preset logits {out.shape}")

    # --- one request at the preset's own seq 256 ----------------------------
    long_req = _request(rng, P, preset.seq_len)
    zero_counts()
    long_out = ServingModel(model, P, dev).predict(long_req)
    check(read_counts() == {**dict.fromkeys(KERNELS, 0), "int8_attention_block": 12, "int8_ffn_block": 12},
          f"preset seq-256 launches {read_counts()}, expected 12 of each int8 kernel")
    check(long_out.shape == (P, preset.num_labels) and bool(np.isfinite(long_out).all()), "preset seq-256 logits")

    # --- the same model on the int8 composite (int8_composite()), and the exact bf16 path
    bert_q = _bert_out(server.model, requests[0], dev)
    long_bert_q = _bert_out(server.model, long_req, dev)
    with int8_composite():
        logit_d = [diff(torch.from_numpy(o), torch.from_numpy(server.predict(r))) for o, r in zip(outs, requests)]
        bert_d = diff(bert_q, _bert_out(server.model, requests[0], dev))
        long_bert_d = diff(long_bert_q, _bert_out(server.model, long_req, dev))
    lmax, lmean = max(d[0] for d in logit_d), max(d[1] for d in logit_d)
    for what, (mx, mean) in (("logits", (lmax, lmean)), ("BERT output", bert_d), ("seq-256 BERT output", long_bert_d)):
        check(mx <= INT8_ATOL and mean < INT8_MEAN, f"preset {what} vs int8 composite: max {mx} mean {mean}")
    exact = _twin(model, BertConfig(), preset.num_labels, dev)  # exact-parity bf16, same weights
    cls_e = _bert_out(exact, requests[0], dev)[:, 0].float()
    cls_d = (bert_q[:, 0].float() - cls_e).abs()
    cls_scale = cls_e.abs().max().item()
    check(cls_d.mean().item() < CLS_DRIFT * cls_scale,
          f"preset CLS drift vs exact bf16: mean {cls_d.mean().item()} on max |CLS| {cls_scale}")
    exact_server = ServingModel(exact, P, dev)
    logits_exact_d = diff(torch.from_numpy(outs[0]), torch.from_numpy(exact_server.predict(requests[0])))
    agree = float((outs[0].argmax(1) == exact_server.predict(requests[0]).argmax(1)).mean())

    # --- images/s at batch 512, preset and exact in turns; p50 at batch 1 ----
    rates = {"preset": [], "exact": []}
    for which in ("preset", "exact", "exact", "preset"):
        rates[which].append(_stream_rate(server if which == "preset" else exact_server, requests[:2], 6))
    p50 = _p50_ms(model, requests[0], dev)

    # --- tower times and the device breakdown at batch 512 -------------------
    r = requests[0]
    with torch.inference_mode():
        img = eval_pipeline(torch.from_numpy(r["image"]).to(dev), 224, normalize=False, dtype=torch.bfloat16)
        ids = torch.from_numpy(r["input_ids"]).to(dev)
        mask = torch.from_numpy(r["attention_mask"]).to(dev)
        fwd = lambda: server.model(img, ids, mask)  # noqa: E731
        towers = {
            "resnet_tower_ms": cuda_ms(lambda: server.model.image_encoder(img), reps=5),
            "bert_tower_int8_kernels_ms": cuda_ms(lambda: server.model.text_encoder(ids, mask), reps=5),
            "bert_tower_int8_composite_ms": _composite_ms(lambda: server.model.text_encoder(ids, mask)),
            "bert_tower_exact_bf16_ms": cuda_ms(lambda: exact.text_encoder(ids, mask), reps=5),
            "forward_ms": cuda_ms(fwd, reps=5),
            "forward_exact_bf16_ms": cuda_ms(lambda: exact(img, ids, mask), reps=5),
        }
        towers["device"] = device_profile(fwd, towers["forward_ms"], reps=2)
        # int8_ffn_block's share of the forward: its own kernels, twelve calls
        fam = towers["device"]["by_family_ms"]
        towers["int8_ffn_device_ms_per_forward"] = fam["int8_ffn_kernels"]
        # int8_attention_block's, by stage: its own kernels and its two row quantizes a layer
        split = int8_attention_stages(fwd, reps=2, blocks=cfg.num_hidden_layers, alone=False)
        towers["int8_attention_device_ms_per_forward"] = {**split, "total": sum(split.values())}

    emit({"phase": "preset", "model": "MIBFNet(num_labels=7): ResNet50 + BERT-base, bf16, "
          "fast_math + quantize=int8 (configs/serving/mibf_ham_serving.yml)",
          "requests": [int(q["image"].shape[0]) for q in requests], "launches": launches,
          "sync_free": sync_free(server.model, requests[0], dev),
          "logits_vs_int8_composite": {"max_abs": lmax, "mean_abs": lmean},
          "bert_out_vs_int8_composite": {"max_abs": bert_d[0], "mean_abs": bert_d[1]},
          "seq256_bert_out_vs_int8_composite": {"max_abs": long_bert_d[0], "mean_abs": long_bert_d[1]},
          "cls_vs_exact_bf16": {"max_abs": cls_d.max().item(), "mean_abs": cls_d.mean().item(),
                                "max_abs_cls": cls_scale},
          "logits_vs_exact_bf16": {"max_abs": logits_exact_d[0], "mean_abs": logits_exact_d[1],
                                   "argmax_agreement": agree},
          "images_per_s_b512_stream": rates["preset"],
          "images_per_s_b512_stream_exact_bf16": rates["exact"],
          "p50_latency_ms_b1": p50, "towers_b512": towers})
    return launches


def phase_seq512(dev, rng, model, plain) -> dict:
    """The exact bf16 model at seq 512, past attention_block's gate."""
    req = _request(rng, BATCH, SEQ512)
    zero_counts()
    out = ServingModel(model, BATCH, dev).predict(req)
    launches = read_counts()
    check(launches == {**dict.fromkeys(KERNELS, 0), "fused_attention": 12, "ffn_block": 12},
          f"seq-512 launches {launches}, expected 12 of fused_attention and ffn_block, no attention_block")
    check(out.shape == (BATCH, LABELS) and bool(np.isfinite(out).all()), "seq-512 logits")
    bert_d = diff(_bert_out(model, req, dev), _bert_out(plain, req, dev))
    logit_d = diff(torch.from_numpy(out), torch.from_numpy(ServingModel(plain, BATCH, dev).predict(req)))
    for what, (mx, mean) in (("BERT output", bert_d), ("logits", logit_d)):
        check(mx <= SLICE_ATOL and mean < SLICE_MEAN, f"seq-512 {what} vs plain: max {mx} mean {mean}")
    with torch.inference_mode():
        ids = torch.from_numpy(req["input_ids"]).to(dev)
        mask = torch.from_numpy(req["attention_mask"]).to(dev)
        towers = {"bert_tower_ms": cuda_ms(lambda: model.text_encoder(ids, mask), reps=5),
                  "bert_tower_device_ms": kernel_device_ms(lambda: model.text_encoder(ids, mask), reps=3),
                  "bert_tower_plain_ms": cuda_ms(lambda: plain.text_encoder(ids, mask), reps=5)}
    emit({"phase": "seq512", "requests": [BATCH], "launches": launches, "sync_free": sync_free(model, req, dev),
          "bert_out_vs_plain": {"max_abs": bert_d[0], "mean_abs": bert_d[1]},
          "logits_vs_plain": {"max_abs": logit_d[0], "mean_abs": logit_d[1]}, "towers_b32": towers})
    return launches


def phase_flash(dev, rng, model) -> dict:
    """The exact model's weights under attention_impl="flash" at seq 512, through
    ServingModel(batch 32): the forward kernel 12 times a forward and no
    sublayer kernel; against the same weights on the plain flash op, and the
    logits against the exact "auto" model (MIBF reads only the CLS token)."""
    cfg = dataclasses.replace(model.text_encoder.bert.cfg, attention_impl="flash")
    flash = _twin(model, cfg, LABELS, dev)
    server = ServingModel(flash, BATCH, dev)
    requests = [_request(rng, n, SEQ512) for n in (BATCH, BATCH, 5)]
    layers = cfg.num_hidden_layers

    # --- the main path: three requests through predict_stream --------------
    zero_counts()
    outs = list(server.predict_stream(iter(requests), depth=2))
    launches = read_counts()
    check(launches == {**dict.fromkeys(KERNELS, 0), "flash_attention": layers * len(requests)},
          f"flash launches {launches}, expected {layers} of flash_attention a forward and no other kernel")
    for req, out in zip(requests, outs):
        n = req["image"].shape[0]
        check(out.shape == (n, LABELS) and bool(np.isfinite(out).all()), f"flash logits {out.shape}")

    # --- the same weights on the plain flash op (the same pad-row semantics) --
    bert_k = _bert_out(flash, requests[0], dev)
    with _plain_op(fl, "flash_attention_forward", fl.flash_attention_reference):
        plain_outs = [server.predict(r) for r in requests]
        bert_d = diff(bert_k, _bert_out(flash, requests[0], dev))
    logit_d = [diff(torch.from_numpy(o), torch.from_numpy(p)) for o, p in zip(outs, plain_outs)]
    lmax, lmean = max(d[0] for d in logit_d), max(d[1] for d in logit_d)
    for what, (mx, mean) in (("BERT output", bert_d), ("logits", (lmax, lmean))):
        check(mx <= SLICE_ATOL and mean < SLICE_MEAN, f"flash {what} vs plain flash op: max {mx} mean {mean}")
    # --- against the exact model: the CLS rows and the logits -----------------
    exact_server = ServingModel(model, BATCH, dev)
    exact_d = [diff(torch.from_numpy(o), torch.from_numpy(exact_server.predict(r))) for o, r in zip(outs, requests)]
    emax, emean = max(d[0] for d in exact_d), max(d[1] for d in exact_d)
    check(emax <= SLICE_ATOL and emean < SLICE_MEAN, f"flash logits vs exact: max {emax} mean {emean}")
    cls_d = diff(bert_k[:, 0], _bert_out(model, requests[0], dev)[:, 0])

    # --- seq 128 takes the kernel, seq 200 (not a multiple of 128) the plain path
    other = {}
    for seq, want in ((SEQ, layers), (200, 0)):
        req = _request(rng, 8, seq)
        zero_counts()
        out = ServingModel(flash, 8, dev).predict(req)
        other[f"seq{seq}"] = read_counts()
        check(other[f"seq{seq}"] == {**dict.fromkeys(KERNELS, 0), "flash_attention": want},
              f"flash seq-{seq} launches {other[f'seq{seq}']}, expected {want} of flash_attention")
        check(out.shape == (8, LABELS) and bool(np.isfinite(out).all()), f"flash seq-{seq} logits")

    # --- rates, tower times and the device breakdown at batch 32 -------------
    images_per_s = _stream_rate(server, requests[:2], 12)
    p50 = _p50_ms(flash, requests[0], dev)
    r = requests[0]
    with torch.inference_mode():
        img = eval_pipeline(torch.from_numpy(r["image"]).to(dev), 224, normalize=False, dtype=torch.bfloat16)
        ids = torch.from_numpy(r["input_ids"]).to(dev)
        mask = torch.from_numpy(r["attention_mask"]).to(dev)
        fwd = lambda: flash(img, ids, mask)  # noqa: E731
        towers = {"bert_tower_flash_ms": cuda_ms(lambda: flash.text_encoder(ids, mask), reps=5),
                  "bert_tower_flash_device_ms": kernel_device_ms(lambda: flash.text_encoder(ids, mask), reps=3),
                  "bert_tower_exact_ms": cuda_ms(lambda: model.text_encoder(ids, mask), reps=5),
                  "forward_ms": cuda_ms(fwd, reps=5), "forward_exact_ms": cuda_ms(lambda: model(img, ids, mask), reps=5)}
        towers["device"] = device_profile(fwd, towers["forward_ms"], top=8)
    emit({"phase": "flash", "model": "MIBFNet(num_labels=7): ResNet50 + BERT-base, bf16, attention_impl=flash, seq 512",
          "requests": [int(q["image"].shape[0]) for q in requests], "launches": launches,
          "sync_free": sync_free(flash, requests[0], dev), "launches_seq128_seq200": other,
          "logits_vs_plain_op": {"max_abs": lmax, "mean_abs": lmean},
          "bert_out_vs_plain_op": {"max_abs": bert_d[0], "mean_abs": bert_d[1]},
          "logits_vs_exact": {"max_abs": emax, "mean_abs": emean},
          "cls_vs_exact": {"max_abs": cls_d[0], "mean_abs": cls_d[1]},
          "images_per_s_b32_stream": images_per_s, "p50_latency_ms_b1": p50, "towers_b32": towers})
    del flash, server, exact_server
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def _plain_op(module, name: str, plain):
    """``module.name`` routed to its plain version, on the card (comparison only)."""
    kernel = getattr(module, name)
    setattr(module, name, plain)
    try:
        yield
    finally:
        setattr(module, name, kernel)


def _route_rows_apart(model, request, dev, g) -> None:
    """Draw the MoE gate at random, then take out its component along the
    mean fused feature of ``request``: with random weights the rows' features
    share most of their direction, so a gate drawn as it is (or JAX's zero
    init) sends every row to the same two experts."""
    with torch.inference_mode():
        img = eval_pipeline(torch.from_numpy(request["image"]).to(dev), 224, normalize=True, dtype=torch.bfloat16)
        feats = model.forward_features(img, torch.from_numpy(request["input_ids"]).to(dev),
                                       torch.from_numpy(request["attention_mask"]).to(dev)).float()
    m = feats.mean(dim=0)
    w = torch.randn(model.classifier.moe.w_gate.shape, generator=g, device=dev)
    with torch.no_grad():
        model.classifier.moe.w_gate.copy_(w - m[:, None] * (m @ w)[None, :] / (m @ m))



def _gate_along_row_spread(model, request, dev, std: float) -> None:
    """Set ConNexT's MoE gate to the principal directions of the centred fused
    features of ``request``'s rows, one an expert, without their part along the
    mean feature, each scaled so that its logits spread over the rows with std
    ``std``. A gate read along random directions
    (``_route_rows_apart``) sees as small a share of the rows' differences, spread
    over 768 directions, as of the bf16 noise between the kernel and the plain
    path, so a few rows sit within that noise of a tie in the top-2; along the
    directions in which the rows differ most the margin is several times wider (the
    phase prints both, ``gate_spread_over_noise``)."""
    with torch.inference_mode():
        img = eval_pipeline(torch.from_numpy(request["image"]).to(dev), CONNEXT_CROP, normalize=True,
                            dtype=torch.bfloat16)
        feats = model.forward_features(img, torch.from_numpy(request["input_ids"]).to(dev),
                                       torch.from_numpy(request["attention_mask"]).to(dev)).float()
    m = feats.mean(dim=0)
    x = feats - m
    w = torch.linalg.svd(x, full_matrices=False)[2][:model.moe.w_gate.shape[1]].T  # (D, E)
    w -= m[:, None] * (m @ w)[None, :] / (m @ m)  # no part along the mean: logits centred over the rows
    with torch.no_grad():
        model.moe.w_gate.copy_(w / (x @ w).std(dim=0) * std)

def phase_baseline(dev, rng, seed: int) -> dict:
    """The baseline family's two served configurations at full width, bf16,
    through ServingModel(batch 64); returns the launches of each main path."""
    result = {}
    runs = (("ham_fusion_ssm_v1", HAM_FUSION_SSM, "selective_scan", 1, ss, ss.selective_scan_reference),
            ("ham_head_moe_v1", HAM_HEAD_MOE, "kan_forward", 2, ks, ks.kan_forward_reference))
    for i, (name, cfg, kernel, per_forward, module, plain) in enumerate(runs):
        g = torch.Generator(device=dev).manual_seed(seed + 10 + i)
        model = init_parameters(MultimodalBaselineModel(cfg, device=dev, dtype=torch.bfloat16), g).eval()
        requests = [_request(rng, n, BASELINE_SEQ) for n in (BASELINE_BATCH, BASELINE_BATCH, 9)]
        if cfg.classifier_type == "moe":
            _route_rows_apart(model, requests[0], dev, g)
        server = ServingModel(model, BASELINE_BATCH, dev)
        layers = cfg.bert.num_hidden_layers

        # --- the main path: three requests through predict_stream, then one of 1 row
        zero_counts()
        outs = list(server.predict_stream(iter(requests), depth=2))
        launches = read_counts()
        by_layer = dict(ks.kan_forward.launches_by_layer)
        want = {**dict.fromkeys(KERNELS, 0), "attention_block": layers * 3, "ffn_block": layers * 3,
                kernel: per_forward * 3}
        check(launches == want, f"{name} launches {launches}, expected {want}")
        if kernel == "kan_forward":
            bank = model.classifier.moe.experts[0].layers
            want_layers = {(l.in_features, l.out_features): 3 for l in bank}
            check(by_layer == want_layers and len(bank) == per_forward,
                  f"{name} kan_forward launches by layer {by_layer}, expected {want_layers}")
            result["kan_forward_by_layer"] = by_layer
        for req, out in zip(requests, outs):
            n = req["image"].shape[0]
            check(out.shape == (n, cfg.num_classes) and bool(np.isfinite(out).all()), f"{name} logits {out.shape}")
        one = {k: v[:1] for k, v in requests[2].items()}
        zero_counts()
        one_out = ServingModel(model, 1, dev).predict(one)
        one_launches = read_counts()
        check(one_launches == {**dict.fromkeys(KERNELS, 0), "attention_block": layers, "ffn_block": layers,
                               kernel: per_forward}, f"{name} batch-1 launches {one_launches}")
        check(bool(np.isfinite(one_out).all()), f"{name} batch-1 logits")

        # --- the same weights with the op routed to its plain version ---------
        with _plain_op(module, kernel, plain):
            plain_outs = [server.predict(r) for r in requests]
        logit_d = [diff(torch.from_numpy(o), torch.from_numpy(p)) for o, p in zip(outs, plain_outs)]
        lmax, lmean = max(d[0] for d in logit_d), max(d[1] for d in logit_d)
        scale = max(float(np.abs(p).max()) for p in plain_outs)
        bound = BF16_STEPS * scale
        check(lmax <= bound and lmean <= BF16_MEAN * scale,
              f"{name} logits kernel vs plain op: max {lmax} (bound {bound}) mean {lmean}, max |logit| {scale}")

        # --- rates, forward time, device breakdown ---------------------------
        images_per_s = _stream_rate(server, requests[:2], 16)
        p50 = _p50_ms(model, requests[0], dev)
        r = requests[0]
        with torch.inference_mode():
            img = eval_pipeline(torch.from_numpy(r["image"]).to(dev), 224, normalize=True, dtype=torch.bfloat16)
            ids = torch.from_numpy(r["input_ids"]).to(dev)
            mask = torch.from_numpy(r["attention_mask"]).to(dev)
            fwd = lambda: server.model(img, ids, mask)  # noqa: E731
            forward_ms = cuda_ms(fwd, reps=10)
            with _plain_op(module, kernel, plain):
                forward_plain_op_ms = cuda_ms(fwd, reps=10)
            device = device_profile(fwd, forward_ms, top=8)
            routes = None
            if cfg.classifier_type == "moe":
                gates, _ = noisy_top_k_gating(server.model.forward_features(img, ids, mask),
                                              server.model.classifier.moe.w_gate, None, cfg.moe_k)
                chosen = ["+".join(map(str, np.flatnonzero(row))) for row in (gates > 0).cpu().numpy()]
                routes = {pair: chosen.count(pair) / len(chosen) for pair in sorted(set(chosen))}
        emit({"phase": "baseline", "config": name, "model": f"MultimodalBaselineModel: {cfg.image_backbone} + "
              f"BERT-base, fusion {cfg.fusion_type}, head {cfg.classifier_type}, hidden {cfg.hidden_dim}, bf16",
              "requests": [int(q["image"].shape[0]) for q in requests], "launches": launches,
              "sync_free": sync_free(server.model, requests[0], dev), "launches_batch1": one_launches, "logits_vs_plain_op": {"max_abs": lmax, "mean_abs": lmean, "max_abs_bound": bound,
                                                        "max_abs_logit": scale},
              "expert_pair_share_b64": routes, "images_per_s_b64_stream": images_per_s, "p50_latency_ms_b1": p50,
              "forward_ms_b64": forward_ms, "forward_plain_op_ms_b64": forward_plain_op_ms, "device_b64": device})
        result[kernel] = launches
        del model, server
        torch.cuda.empty_cache()
    return result


def _train_batch(rng, n_valid: int) -> dict:
    """A loader-shaped host batch: uint8 canvases, seq-256 tokens, labels and n_valid."""
    b = _request(rng, MIBF_HAM_TRAIN.batch_size, MIBF_HAM_TRAIN.seq_len)
    b["label"] = rng.integers(0, LABELS, MIBF_HAM_TRAIN.batch_size).astype(np.int64)
    b["n_valid"] = np.int32(n_valid)
    return b


def _towers(model) -> dict:
    """Parameter-name prefixes of the towers whose gradients are compared."""
    groups = {"image_encoder": [], "text_encoder": [], "textbased_cross_attention": [],
              "imagbased_cross_attention": [], "heads": []}
    for name, p in model.named_parameters():
        top = name.split(".")[0]
        groups[top if top in groups else "heads"].append(p)
    return groups


def _grad_cosines(a, b) -> dict:
    out = {}
    for (name, pa), (_, pb) in zip(_towers(a).items(), _towers(b).items()):
        ga = torch.cat([p.grad.double().flatten() for p in pa])
        gb = torch.cat([p.grad.double().flatten() for p in pb])
        out[name] = (ga @ gb / (ga.norm() * gb.norm() + 1e-30)).item()
    return out


def _forward_flops(model, images, ids, mask) -> float:
    """FLOPs of one training-mode forward, from the shapes: every convolution
    and Linear (2 * outputs * fan-in) plus BERT's attention products (4 B L^2 H
    a layer). The step is counted as three forwards (backward ~ 2x)."""
    total = [0.0]

    def conv(m, i, o):
        total[0] += 2.0 * o.numel() * (m.in_channels // m.groups) * m.kernel_size[0] * m.kernel_size[1]

    def lin(m, i, o):
        total[0] += 2.0 * o.numel() * m.in_features

    hooks = [m.register_forward_hook(conv if isinstance(m, nn.Conv2d) else lin)
             for m in model.modules() if isinstance(m, (nn.Conv2d, nn.Linear))]
    try:
        with torch.no_grad():
            model.train()
            model(images, ids, mask)
    finally:
        for h in hooks:
            h.remove()
    cfg = model.text_encoder.bert.cfg
    B, L = ids.shape
    return total[0] + 4.0 * B * L * L * cfg.hidden_size * cfg.num_hidden_layers


def _step_parts_ms(trainer, batch, reps: int = 3) -> dict:
    """Median CUDA-event times of one step's parts: augmentation, forward +
    backward, optimizer (H2D staged before the first event)."""
    parts = {"augment_ms": [], "forward_backward_ms": [], "optimizer_ms": [], "step_ms": []}
    for _ in range(reps):
        dev_b = trainer.to_device(batch)
        valid = trainer.valid_mask(batch, dev_b["label"].shape[0])
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        images = trainer.augment(dev_b["image"])
        ev[1].record()
        trainer.forward_backward(images, dev_b, valid)
        ev[2].record()
        trainer.optimizer_step()
        ev[3].record()
        ev[3].synchronize()
        parts["augment_ms"].append(ev[0].elapsed_time(ev[1]))
        parts["forward_backward_ms"].append(ev[1].elapsed_time(ev[2]))
        parts["optimizer_ms"].append(ev[2].elapsed_time(ev[3]))
        parts["step_ms"].append(ev[0].elapsed_time(ev[3]))
    return {k: statistics.median(v) for k, v in parts.items()}


def _images_per_s(trainer, batches, steps: int = 4) -> float:
    """Host clock over ``steps`` whole train_steps (H2D, augmentation, forward,
    backward, Adam) after two of warm-up."""
    for b in batches[:2]:
        trainer.train_step(b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        trainer.train_step(batches[i % len(batches)])
    torch.cuda.synchronize()
    return steps * batches[0]["label"].shape[0] / (time.perf_counter() - t0)


def _damp_residual_branches(model) -> nn.Module:
    with torch.no_grad():
        for name, m in model.image_encoder.named_modules():
            if name.endswith(".bn3"):
                m.weight.fill_(RESIDUAL_BN_SCALE)
    return model


def _bn_ab_split(ab_device: dict, bn_inputs: list) -> dict:
    """The A/B's device forward + backward, each side's total, and its parts: the two
    bn_stats kernels summed over the step beside the sum of their bounds, cuDNN's
    BatchNorm kernels, and the BatchNorm apply the switch's side still runs in
    PyTorch ((x - mean) * mul + bias and its autograd): everything else is the same
    on both sides, so the apply is the switch side's time less its bn_stats kernels,
    less what the cuDNN side spends outside cuDNN's BatchNorm."""
    fam = {w: d["by_family_ms"] for w, d in ab_device.items()}
    rows = [(s[0] * s[2] * s[3], s[1], torch.empty((), dtype=dt).element_size()) for s, dt in bn_inputs]
    kernels = fam["bn_stats"]["bn_stats_kernel"] + fam["bn_stats"]["bn_stats_backward_kernel"]
    return {"device_ms": {w: d["kernel_ms"] for w, d in ab_device.items()},
            "bn_stats_kernel_ms": fam["bn_stats"]["bn_stats_kernel"],
            "bn_stats_kernel_bound_ms": sum(bound_bn_stats(*r)[0] for r in rows),
            "bn_stats_backward_kernel_ms": fam["bn_stats"]["bn_stats_backward_kernel"],
            "bn_stats_backward_kernel_bound_ms": sum(bound_bn_stats_backward(*r)[0] for r in rows),
            "cudnn_batch_norm_ms": fam["cudnn"]["batch_norm"],
            "bn_apply_ms": ab_device["bn_stats"]["kernel_ms"] - kernels
            - (ab_device["cudnn"]["kernel_ms"] - fam["cudnn"]["batch_norm"]),
            "family_delta_ms": {k: fam["bn_stats"][k] - fam["cudnn"][k] for k in fam["cudnn"]
                                if fam["bn_stats"][k] != fam["cudnn"][k]}}


def phase_train(dev, rng, seed: int) -> dict:
    """MIBF-Net training at full width (MIBF_HAM_TRAIN): Trainer.fit, the
    launches of each path, augmentation kernel vs plain, rates and times, the
    bf16 step against a float32 twin, and the bn_stats A/B."""
    preset = MIBF_HAM_TRAIN
    B = preset.batch_size
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    master = _damp_residual_branches(init_parameters(MIBFNet(preset.num_labels, preset.bert, device=dev), g))
    trainer = Trainer(preset, model=master, device=dev)  # bf16 working module
    train = [_train_batch(rng, n) for n in (B, B, 21)]  # the last batch is short: 11 padded rows
    val = [_train_batch(rng, B), _train_batch(rng, 19)]
    masters = dict(zip((n for n, _ in trainer.model.named_parameters()), trainer.master_parameters()))
    watch = {n: masters[n].detach().clone() for n in ("fc.weight", "image_encoder.conv1.weight",
                                                      "text_encoder.bert.encoder.layer.0.attention.self.query.weight")}
    bn1 = trainer.model.image_encoder.bn1
    rm0 = bn1.running_mean.clone()

    # --- the main path: Trainer.fit, 2 epochs x 3 steps, validation on 2 batches an epoch
    zero_counts()
    history = trainer.fit(train, val, num_epochs=2, steps_per_epoch=3)
    launches = read_counts()
    layers, n_steps, n_val = preset.bert.num_hidden_layers, 6, 4
    want = {**dict.fromkeys(KERNELS, 0), "shear_sublane": 3 * n_steps, "attention_block": layers * n_val,
            "ffn_block": layers * n_val}
    check(launches == want, f"fit launches {launches}, expected {want}")
    losses = [x for h in history for x in h["train_losses"]] + [h["val_loss"] for h in history]
    check(all(np.isfinite(losses)), f"non-finite losses {losses}")
    check(all(not torch.equal(p, masters[n]) for n, p in watch.items()), "parameters unchanged")
    check(bn1.running_var.dtype == torch.float32 and bn1.running_mean.dtype == torch.float32
          and not torch.equal(bn1.running_mean, rm0), "BatchNorm running statistics not updated in float32")
    check(int(bn1.num_batches_tracked) == n_steps, f"num_batches_tracked {int(bn1.num_batches_tracked)}")

    # --- each path alone: a training step launches the three shears and nothing else;
    # --- a validation forward the two sublayer kernels, 12 each
    zero_counts()
    trainer.train_step(train[0])
    step_launches = read_counts()
    check(step_launches == {**dict.fromkeys(KERNELS, 0), "shear_sublane": 3}, f"train_step launches {step_launches}")
    zero_counts()
    trainer.validate(val[:1])
    val_launches = read_counts()
    check(val_launches == {**dict.fromkeys(KERNELS, 0), "attention_block": layers, "ffn_block": layers},
          f"validation launches {val_launches}")

    # --- the augmentation: kernel against plain version on the same sampled values
    canv = trainer.to_device(train[1])["image"]
    p = aug.sample_crop_flip_rotate(B, preset.canvas, trainer.generator, vflip=preset.vflip, degrees=preset.degrees)
    x_kernel = trainer.augment(canv, params=p)
    with _plain_op(aug, "shear_sublane", sh.shear_reference):  # rotate_3shear through the plain shear
        x_plain = trainer.augment(canv, params=p)
    aug_d = diff(x_kernel, x_plain)
    check(aug_d[0] == 0.0 and x_kernel.shape == (B, 3, preset.image_size, preset.image_size),
          f"augmentation kernel vs plain: {aug_d}, shape {tuple(x_kernel.shape)}")

    # --- rates and times of the step
    images_per_s = _images_per_s(trainer, train)
    parts = _step_parts_ms(trainer, train[0])
    device = device_profile(lambda: trainer.train_step(train[0]), parts["step_ms"], reps=2, top=15)
    with torch.no_grad():
        dev_b = trainer.to_device(train[0])
        images = trainer.augment(dev_b["image"])
    step_flops = 3.0 * _forward_flops(trainer.model, images, dev_b["input_ids"], dev_b["attention_mask"])
    flop_share = step_flops / (parts["step_ms"] / 1e3) / BF16_OPS

    # --- bn_stats A/B: the same weights and batch, cuDNN BatchNorm against
    # --- MIBFNet(bn_stats_kernel=True) in a trainer of its own
    twin = MIBFNet(preset.num_labels, preset.bert, bn_stats_kernel=True, device=dev)
    twin.load_state_dict({k: v.float() if v.is_floating_point() else v for k, v in trainer.model.state_dict().items()})
    trainers = {"cudnn": trainer, "bn_stats": Trainer(preset, model=twin, device=dev)}
    valid = trainer.valid_mask(train[0], B)
    bn_inputs = []
    hooks = [m.register_forward_pre_hook(lambda m, i: bn_inputs.append((tuple(i[0].shape), i[0].dtype)))
             for m in trainer.model.modules() if isinstance(m, BatchNorm2d)]
    zero_counts()
    torch.manual_seed(seed)  # the same dropout masks in both runs
    loss_cudnn, _ = trainer.forward_backward(images, dev_b, valid)
    for h in hooks:
        h.remove()
    check(bns.bn_stats.launches == 0, "bn_stats launched with the switch off")
    accepted = sum(bns.supports((s[0] * s[2] * s[3], s[1]), dt) for s, dt in bn_inputs)
    zero_counts()
    torch.manual_seed(seed)
    loss_kernel, _ = trainers["bn_stats"].forward_backward(images, dev_b, valid)
    ab_launches = read_counts()
    check(ab_launches == {**dict.fromkeys(KERNELS, 0), "bn_stats": accepted, "bn_stats_backward": accepted},
          f"bn_stats A/B launches {ab_launches}, expected {accepted} of {len(bn_inputs)} BatchNorm inputs each")
    rel = abs(loss_kernel.item() - loss_cudnn.item()) / abs(loss_cudnn.item())
    check(rel <= BN_AB_LOSS_REL, f"bn_stats A/B loss {loss_kernel.item()} vs {loss_cudnn.item()}")
    zero_counts()
    trainers["bn_stats"].validate(val[:1])
    check(bns.bn_stats.launches == 0, "bn_stats launched in eval")
    ab_parts = {"cudnn": [], "bn_stats": []}
    for which in ("cudnn", "bn_stats", "bn_stats", "cudnn"):
        ab_parts[which].append(_step_parts_ms(trainers[which], train[0], reps=3))
    ab_ms = {w: [p["step_ms"] for p in v] for w, v in ab_parts.items()}
    ab_device = {}
    for which in trainers:
        fb_ms = statistics.median(p["forward_backward_ms"] for p in ab_parts[which])
        ab_device[which] = device_profile(lambda t=trainers[which]: t.forward_backward(images, dev_b, valid),
                                          fb_ms, reps=1)
    ab_split = _bn_ab_split(ab_device, bn_inputs)
    del trainer, trainers, master, twin
    torch.cuda.empty_cache()

    # --- the bf16 step against a float32 twin: same weights, same augmented batch, dropout 0;
    # --- checked with the damped residual branches, reported for the seeded init as it is
    nodrop = dataclasses.replace(preset, bert=dataclasses.replace(preset.bert, hidden_dropout=0.0,
                                                                 attention_dropout=0.0))
    mixed = {}
    for which, damp in (("damped", True), ("seeded_init", False)):
        g = torch.Generator(device=dev).manual_seed(seed + 3)
        m16 = init_parameters(MIBFNet(preset.num_labels, nodrop.bert, device=dev), g)
        t16 = Trainer(nodrop, model=_damp_residual_branches(m16) if damp else m16, device=dev)
        twin = MIBFNet(preset.num_labels, nodrop.bert, device=dev)
        twin.load_state_dict({k: v.float() if v.is_floating_point() else v for k, v in t16.model.state_dict().items()})
        t32 = Trainer(dataclasses.replace(nodrop, precision="f32"), model=twin, device=dev)
        dev_b = t32.to_device(train[0])
        valid = t32.valid_mask(train[0], B)
        x32 = t32.augment(dev_b["image"])
        loss32, _ = t32.forward_backward(x32, dev_b, valid)
        loss16, _ = t16.forward_backward(x32.to(torch.bfloat16), dev_b, valid)
        mixed[which] = {"loss_bf16": loss16.item(), "loss_f32": loss32.item(),
                        "loss_rel": abs(loss16.item() - loss32.item()) / abs(loss32.item()),
                        "grad_cosine": _grad_cosines(t16.model, t32.model)}
        del t16, t32, twin, m16
        torch.cuda.empty_cache()
    d = mixed["damped"]
    check(d["loss_rel"] <= MIXED_LOSS_REL, f"bf16 vs float32 loss: {mixed}")
    check(all(c >= MIXED_GRAD_COS for c in d["grad_cosine"].values()), f"bf16 vs float32 gradients: {mixed}")

    emit({"phase": "train", "model": "MIBFNet(num_labels=7): ResNet50 + BERT-base, bf16 module with float32 "
          f"masters, residual-branch BatchNorm scale {RESIDUAL_BN_SCALE}, MIBF_HAM_TRAIN (configs/mibf/mibf_ham.yml): batch 32, seq 256, canvas 256 -> 224, Adam 2e-5, "
          "cosine, KL_loss, degrees 15",
          "history": history, "launches_fit": launches, "launches_train_step": step_launches,
          "launches_validation_forward": val_launches, "augment_kernel_vs_plain_max_abs": aug_d[0],
          "images_per_s_b32": images_per_s, "step_parts_ms": parts, "device": device,
          "step_tflop": step_flops / 1e12, "flop_share_of_989_tflops": flop_share,
          "bn_stats_ab": {"bn_inputs": len(bn_inputs), "accepted": accepted, "launches": ab_launches["bn_stats"],
                          "loss_cudnn": loss_cudnn.item(), "loss_bn_stats": loss_kernel.item(), "loss_rel": rel,
                          "step_ms": ab_ms, "device_forward_backward": ab_device, **ab_split},
          "bf16_vs_f32": mixed})
    return {"launches": launches, "ab_launches": ab_launches}


def phase_train_flash(dev, rng, seed: int) -> dict:
    """MIBF_HAM_TRAIN with BERT under attention_impl="flash" and attention
    dropout 0: Trainer.fit over 2 steps and a validation batch, the launches
    of a step and of a validation forward, one step against the plain flash
    op, and step ms and the device breakdown in turns against the same preset
    under "auto" (attention dropout 0 as well, the plain training path)."""
    base = MIBF_HAM_TRAIN
    B, layers = base.batch_size, base.bert.num_hidden_layers
    presets = {impl: dataclasses.replace(base, bert=dataclasses.replace(base.bert, attention_impl=impl,
                                                                       attention_dropout=0.0))
               for impl in ("flash", "auto")}
    g = torch.Generator(device=dev).manual_seed(seed + 4)
    master = _damp_residual_branches(init_parameters(MIBFNet(base.num_labels, presets["flash"].bert, device=dev), g))
    twin = MIBFNet(base.num_labels, presets["auto"].bert, device=dev)
    twin.load_state_dict(master.state_dict())
    trainers = {impl: Trainer(presets[impl], model=m, device=dev) for impl, m in (("flash", master), ("auto", twin))}
    trainer = trainers["flash"]
    train = [_train_batch(rng, B), _train_batch(rng, B)]
    val = [_train_batch(rng, B)]

    # --- the main path: Trainer.fit, one epoch of 2 steps and a validation batch
    zero_counts()
    history = trainer.fit(train, val, num_epochs=1, steps_per_epoch=2)
    launches = read_counts()
    want = {**dict.fromkeys(KERNELS, 0), "shear_sublane": 6, "flash_attention": 3 * layers,
            "flash_attention_bwd_dkv": 2 * layers, "flash_attention_bwd_dq": 2 * layers}
    check(launches == want, f"flash fit launches {launches}, expected {want}")
    losses = history[0]["train_losses"] + [history[0]["val_loss"]]
    check(all(np.isfinite(losses)), f"non-finite flash losses {losses}")
    zero_counts()
    trainer.train_step(train[0])
    step_launches = read_counts()
    check(step_launches == {**dict.fromkeys(KERNELS, 0), "shear_sublane": 3, "flash_attention": layers,
                            "flash_attention_bwd_dkv": layers, "flash_attention_bwd_dq": layers},
          f"flash train_step launches {step_launches}")
    zero_counts()
    trainer.validate(val)
    val_launches = read_counts()
    check(val_launches == {**dict.fromkeys(KERNELS, 0), "flash_attention": layers},
          f"flash validation launches {val_launches}")

    # --- one step against the plain flash op: same weights, batch, images and dropout masks
    dev_b = trainer.to_device(train[0])
    valid = trainer.valid_mask(train[0], B)
    with torch.no_grad():
        images = trainer.augment(dev_b["image"])
    bert_params = list(trainer.model.text_encoder.parameters())
    step = {}
    for which in ("kernels", "plain"):
        with contextlib.ExitStack() as stack:
            if which == "plain":
                for name, plain in (("flash_attention_forward", fl.flash_attention_reference),
                                    ("flash_attention_bwd_dkv", fl.flash_attention_bwd_dkv_reference),
                                    ("flash_attention_bwd_dq", fl.flash_attention_bwd_dq_reference)):
                    stack.enter_context(_plain_op(fl, name, plain))
            torch.manual_seed(seed)
            loss, _ = trainer.forward_backward(images, dev_b, valid)
        step[which] = (loss.item(), torch.cat([p.grad.double().flatten() for p in bert_params]))
    (loss_k, gk), (loss_p, gp) = step["kernels"], step["plain"]
    rel = abs(loss_k - loss_p) / abs(loss_p)
    cos = (gk @ gp / (gk.norm() * gp.norm() + 1e-30)).item()
    check(rel <= FLASH_LOSS_REL and cos >= FLASH_GRAD_COS,
          f"flash step vs plain flash op: loss {loss_k} vs {loss_p}, BERT gradient cosine {cos}")
    del step, gk, gp

    # --- step ms in turns against "auto", and each step's device breakdown
    parts = {"auto": [], "flash": []}
    for which in ("auto", "flash", "flash", "auto"):
        parts[which].append(_step_parts_ms(trainers[which], train[0], reps=3))
    device = {w: device_profile(lambda t=trainers[w]: t.train_step(train[0]),
                                statistics.median(p["step_ms"] for p in parts[w]), reps=2, top=12)
              for w in trainers}
    emit({"phase": "train_flash", "model": "MIBFNet(num_labels=7), MIBF_HAM_TRAIN (batch 32, seq 256) with BERT "
          "attention_impl=flash, attention_dropout 0; bf16 module, float32 masters, residual-branch BatchNorm "
          f"scale {RESIDUAL_BN_SCALE}", "history": history, "launches_fit": launches,
          "launches_train_step": step_launches, "launches_validation_forward": val_launches,
          "step_vs_plain_op": {"loss_kernels": loss_k, "loss_plain": loss_p, "loss_rel": rel,
                               "bert_grad_cosine": cos},
          "step_parts_ms": parts, "device": device})
    del trainers, trainer, master, twin
    torch.cuda.empty_cache()
    return launches


def _layer_scales(model) -> list:
    return [layer.layer_scale_parameter for stage in model.image_encoder.encoder.stages for layer in stage.layers]


def phase_connext(dev, seed: int) -> dict:
    """ConNexT served at full width (CONNEXT_HAM: ConvNeXt-base + BERT-base at seq
    512, the KAN-expert MoE head), bf16, through ServingModel(batch 32); returns the
    launches of the main path and kan_forward's by layer."""
    rng = np.random.default_rng([seed, 20])  # inputs of its own: the other phases' stay as they were
    g = torch.Generator(device=dev).manual_seed(seed + 20)
    model = init_parameters(ConNexTClassifier(CONNEXT_HAM, device=dev, dtype=torch.bfloat16), g).eval()
    server = ServingModel(model, CONNEXT_BATCH, dev, image_size=CONNEXT_CROP)  # channels_last weights from here on
    bank = model.moe.experts[0].layers
    check((bank[0].in_features, *(l.out_features for l in bank)) == CONNEXT_BANK, f"ConNexT's bank {bank}")
    requests = [_request(rng, n, CONNEXT_SEQ) for n in (CONNEXT_BATCH, CONNEXT_BATCH, 5)]
    r = requests[0]
    with torch.inference_mode():
        img = eval_pipeline(torch.from_numpy(r["image"]).to(dev), CONNEXT_CROP, normalize=True, dtype=torch.bfloat16)
        ids = torch.from_numpy(r["input_ids"]).to(dev)
        mask = torch.from_numpy(r["attention_mask"]).to(dev)
    # --- the stated weights: layer scales at LAYER_SCALE (checked to carry the map), the image-side
    # query and key at CONNEXT_QK_SCALE, the gate along the rows' spread (CONNEXT_GATE_STD)
    with torch.no_grad():
        with torch.inference_mode():
            fmap_init = model.image_encoder(img).float()
        for p in _layer_scales(model):
            p.fill_(LAYER_SCALE)
        attn = model.imagbased_cross_attention
        for conv in (attn.query_conv, attn.key_conv):
            conv.weight.mul_(CONNEXT_QK_SCALE)
    _gate_along_row_spread(model, r, dev, CONNEXT_GATE_STD)
    with torch.inference_mode():
        cls, fmap = model.towers(img, ids, mask)
        signal = ((fmap.float() - fmap_init).norm() / fmap.float().norm()).item()
        check(bool(torch.isfinite(fmap).all()) and signal >= CONNEXT_SIGNAL,
              f"ConvNeXt map at layer scale {LAYER_SCALE}: moved {signal} of its norm against the init's")
        reduced = F.linear(fmap, model.conv.weight.flatten(1), model.conv.bias).flatten(1, 2)
        scores = (attn.conv1x1(attn.query_conv, cls[:, None, None, :]) @
                  attn.conv1x1(attn.key_conv, reduced[:, :, None, :]).transpose(1, 2)).float()
        imag_scores = {"std": scores.std().item(), "max_abs": scores.abs().max().item()}
    layers = CONNEXT_HAM.bert.num_hidden_layers

    # --- the main path: three requests through predict_stream, then one of 1 row
    zero_counts()
    outs = list(server.predict_stream(iter(requests), depth=2))
    launches = read_counts()
    by_layer = dict(ks.kan_forward.launches_by_layer)
    n_bank = len(CONNEXT_BANK) - 1
    want = {**dict.fromkeys(KERNELS, 0), "fused_attention": layers * 3, "ffn_block": layers * 3,
            "kan_forward": n_bank * 3}
    check(launches == want, f"connext launches {launches}, expected {want}")
    want_layers = {io: 3 for io in zip(CONNEXT_BANK, CONNEXT_BANK[1:])}
    check(by_layer == want_layers, f"connext kan_forward launches by layer {by_layer}, expected {want_layers}")
    for req, out in zip(requests, outs):
        n = req["image"].shape[0]
        check(out.shape == (n, CONNEXT_HAM.num_labels) and bool(np.isfinite(out).all()), f"connext logits {out.shape}")
    one = {k: v[:1] for k, v in requests[2].items()}
    zero_counts()
    one_out = ServingModel(model, 1, dev, image_size=CONNEXT_CROP).predict(one)
    one_launches = read_counts()
    check(one_launches == {**dict.fromkeys(KERNELS, 0), "fused_attention": layers, "ffn_block": layers,
                           "kan_forward": n_bank}, f"connext batch-1 launches {one_launches}")
    check(bool(np.isfinite(one_out).all()), "connext batch-1 logits")

    # --- the same weights on the plain path: BERT under "xla", kan_forward's plain version.
    # The towers apart (BERT's CLS within the model bound, the ConvNeXt map the same bits: the
    # same cuDNN path), the head on equal inputs, then the logits.
    plain = ConNexTClassifier(dataclasses.replace(CONNEXT_HAM, bert=dataclasses.replace(
        CONNEXT_HAM.bert, attention_impl="xla")), device=dev, dtype=torch.bfloat16).eval()
    plain.load_state_dict(model.state_dict())
    plain_server = ServingModel(plain, CONNEXT_BATCH, dev, image_size=CONNEXT_CROP)
    with torch.inference_mode():
        cls_plain, fmap_plain = plain.towers(img, ids, mask)
        fused = model.fuse(cls, fmap)
        head, _ = model.classify(fused)
        with _plain_op(ks, "kan_forward", ks.kan_forward_reference):
            head_plain, _ = model.classify(fused)
            plain_outs = [plain_server.predict(q) for q in requests]
    # the gate logits' spread over the rows against the two paths' difference in them (its rms), the
    # least over the experts, for this gate and for one drawn as _route_rows_apart draws it
    with torch.inference_mode():
        noise = fused.float() - model.fuse(cls_plain, fmap_plain).float()
        w_random = torch.randn(model.moe.w_gate.shape, generator=g, device=dev)
        m = fused.float().mean(dim=0)
        w_random -= m[:, None] * (m @ w_random)[None, :] / (m @ m)
        gate_margin = {name: ((fused.float() @ w).std(dim=0) / (noise @ w).pow(2).mean(dim=0).sqrt()).min().item()
                       for name, w in (("row_spread_gate", model.moe.w_gate), ("random_gate", w_random))}
    cls_d = diff(cls, cls_plain)
    check(cls_d[0] <= SLICE_ATOL and cls_d[1] < SLICE_MEAN, f"connext CLS kernel vs plain path: {cls_d}")
    check(torch.equal(fmap, fmap_plain), "connext ConvNeXt map differs between two runs of the same path")
    head_scale = head_plain.abs().max().item()
    head_d = diff(head, head_plain)
    check(head_d[0] <= BF16_STEPS * head_scale and head_d[1] <= BF16_MEAN * head_scale,
          f"connext head kernel vs plain op: {head_d}, max |logit| {head_scale}")
    logit_d = [diff(torch.from_numpy(o), torch.from_numpy(p)) for o, p in zip(outs, plain_outs)]
    lmax, lmean = max(d[0] for d in logit_d), max(d[1] for d in logit_d)
    scale = max(float(np.abs(p).max()) for p in plain_outs)
    check(lmax <= CONNEXT_LOGIT_MAX * scale and lmean <= CONNEXT_LOGIT_MEAN * scale,
          f"connext logits kernel vs plain path: max {lmax} mean {lmean}, max |logit| {scale}")

    # --- routing, rates, tower and forward times, the device breakdown at batch 32
    with torch.inference_mode():
        gates, _ = noisy_top_k_gating(fused, model.moe.w_gate, None, CONNEXT_HAM.moe_k)
    chosen = ["+".join(map(str, np.flatnonzero(row))) for row in (gates > 0).cpu().numpy()]
    experts = {e for pair in chosen for e in pair.split("+")}
    top1_gate_mean = gates.max(dim=1).values.mean().item()
    check(len(experts) == CONNEXT_HAM.moe_num_experts, f"connext rows chose only experts {sorted(experts)}")
    images_per_s = _stream_rate(server, requests[:2], 12)
    p50 = _p50_ms(model, requests[0], dev)
    with torch.inference_mode():
        fwd = lambda: server.model(img, ids, mask)  # noqa: E731
        forward_ms = cuda_ms(fwd, reps=5)
        with _plain_op(ks, "kan_forward", ks.kan_forward_reference):
            forward_plain_ms = cuda_ms(lambda: plain(img, ids, mask), reps=3)
        towers = {"bert_tower_ms": cuda_ms(lambda: model.text_encoder(ids, mask), reps=5),
                  "bert_tower_plain_ms": cuda_ms(lambda: plain.text_encoder(ids, mask), reps=5),
                  "convnext_tower_ms": cuda_ms(lambda: model.image_encoder(img), reps=5),
                  "head_ms": cuda_ms(lambda: model.classify(model.fuse(cls, fmap)), reps=5)}
        device = device_profile(fwd, forward_ms, top=8)
    emit({"phase": "connext", "config": "connext_ham", "model": "ConNexTClassifier: ConvNeXt-base + BERT-base, "
          f"fusion 768, MoE head 4 KAN experts {list(CONNEXT_BANK)} top-2, bf16, seq {CONNEXT_SEQ}",
          "requests": [int(q["image"].shape[0]) for q in requests], "launches": launches,
          "kan_forward_by_layer": {f"{i}->{o}": n for (i, o), n in by_layer.items()}, "launches_batch1": one_launches,
          "sync_free": sync_free(model, requests[0], dev), "layer_scale": LAYER_SCALE, "map_signal": signal,
          "qk_scale": CONNEXT_QK_SCALE, "imag_scores": imag_scores, "gate_spread_over_noise": gate_margin,
          "cls_vs_plain": {"max_abs": cls_d[0], "mean_abs": cls_d[1]},
          "head_vs_plain_op": {"max_abs": head_d[0], "mean_abs": head_d[1], "max_abs_logit": head_scale},
          "logits_vs_plain": {"max_abs": lmax, "mean_abs": lmean, "max_abs_logit": scale},
          "top1_gate_mean": top1_gate_mean, "expert_pair_share_b32": {pair: chosen.count(pair) / len(chosen) for pair in sorted(set(chosen))},
          "images_per_s_b32_stream": images_per_s, "p50_latency_ms_b1": p50, "forward_ms_b32": forward_ms,
          "forward_plain_ms_b32": forward_plain_ms, "towers_b32": towers, "device_b32": device})
    del model, plain, server, plain_server
    torch.cuda.empty_cache()
    return {"launches": launches, "kan_forward_by_layer": by_layer}


def _connext_train_batch(rng, n_valid: int) -> dict:
    """A loader-shaped ConNexT batch: uint8 canvases, seq-512 tokens, labels and n_valid."""
    b = _request(rng, CONNEXT_BATCH, CONNEXT_SEQ)
    b["label"] = rng.integers(0, CONNEXT_HAM.num_labels, CONNEXT_BATCH).astype(np.int64)
    b["n_valid"] = np.int32(n_valid)
    return b


def _run_files(out: str) -> dict:
    """What a training run wrote: the metric tags, finite values, the checkpoint index."""
    recs = [json.loads(line) for line in Path(out, "metrics.jsonl").read_text().splitlines()]
    index = json.loads(Path(out, "checkpoints.json").read_text())
    check(Path(out, "training.log").stat().st_size > 0 and Path(out, "last.pt").exists()
          and Path(out, "config.json").exists(), f"{out}: training.log, last.pt or config.json missing")
    check(all(np.isfinite(r["value"]) for r in recs), f"{out}: non-finite metric records")
    check(1 <= len(index) <= 3 and index == sorted(index, key=lambda e: -e["metric"])
          and all(Path(out, e["path"]).exists() for e in index), f"{out}: checkpoints.json {index}")
    tags = sorted({r["tag"] for r in recs})
    for tag in ("Loss/Train_Batch", "Loss/Train_Epoch", "Loss/Validation", "Accuracy/Validation", "LearningRate"):
        check(tag in tags, f"{out}: no {tag} record")
    return {"tags": tags, "records": len(recs), "checkpoints": index}


def phase_train_connext(dev, seed: int) -> dict:
    """ConNexT trained at full width (connext_ham.json: ConvNeXt-base + BERT-base at seq 512, batch 32,
    the four-layer KAN bank, colour jitter and 45-degree rotation) through the config-driven Trainer:
    fit over 2 epochs of 2 steps with validation, the launches of each path, the 45-degree shears
    against the plain shear, one step against the plain kan_forward, rates, the device breakdown and
    peak memory; returns the launches of the fit."""
    rng = np.random.default_rng([seed, 25])  # inputs of its own
    g = torch.Generator(device=dev).manual_seed(seed + 25)
    run_dir = REPO / "mdhs_tpu_torch" / "build" / "train_connext_smoke"  # git-ignored; removed at the end
    shutil.rmtree(run_dir, ignore_errors=True)
    cfg = load_config(REPO / "mdhs_tpu_torch" / "configs" / "connext_ham.json",
                      overrides=["training.log_every=1", "training.log_per_class=true"])
    # float32 masters with phase_connext's stated weights: layer scales, the image-side query and key
    model = init_parameters(ConNexTClassifier(CONNEXT_HAM, device=dev), g)
    with torch.no_grad():
        for p in _layer_scales(model):
            p.fill_(LAYER_SCALE)
        for conv in (model.imagbased_cross_attention.query_conv, model.imagbased_cross_attention.key_conv):
            conv.weight.mul_(CONNEXT_QK_SCALE)
    torch.cuda.reset_peak_memory_stats(dev)
    trainer = Trainer(cfg, "connext", output_dir=str(run_dir), device=dev, setup_data=False, model=model)
    B, layers, n_bank = CONNEXT_BATCH, CONNEXT_HAM.bert.num_hidden_layers, len(CONNEXT_BANK) - 1
    train = [_connext_train_batch(rng, B), _connext_train_batch(rng, 23)]  # the second one short: 9 padded rows
    val = [_connext_train_batch(rng, B)]
    trainer.model.eval()
    _gate_along_row_spread(trainer.model, train[0], dev, CONNEXT_GATE_STD)  # w_gate is its own float32 master
    trainer.model.train()
    check(aug.shear_pads(CONNEXT_CROP, trainer.preset.degrees) == (49, 82) and trainer.preset.vflip
          and trainer.preset.color_jitter and trainer.preset.normalize, f"connext augmentation {trainer.preset}")
    masters = dict(zip((n for n, _ in trainer.model.named_parameters()), trainer.master_parameters()))
    watch = {n: masters[n].detach().clone() for n in ("moe.experts.0.layers.0.base_weight", "moe.w_gate",
                                                      "image_encoder.embeddings.patch_embeddings.weight",
                                                      "text_encoder.bert.encoder.layer.0.attention.self.query.weight")}

    # --- the main path: Trainer.fit, 2 epochs x 2 steps, validation on one batch an epoch
    zero_counts()
    t0 = time.perf_counter()
    history = trainer.fit(train, val, num_epochs=2, steps_per_epoch=2)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    want = {**dict.fromkeys(KERNELS, 0), "shear_sublane": 3 * 4, "kan_forward": n_bank * (4 + 2),
            "fused_attention": layers * 2, "ffn_block": layers * 2}
    check(launches == want, f"connext fit launches {launches}, expected {want}")
    losses = [x for h in history for x in h["train_losses"]] + [h["val_loss"] for h in history]
    check(all(np.isfinite(losses)), f"non-finite connext losses {losses}")
    check(all(not torch.equal(p, masters[n]) for n, p in watch.items()), "connext parameters unchanged")
    files = _run_files(str(run_dir))
    check("per_class/f1_class_6" in files["tags"] and "val/auroc_macro" in files["tags"], "no per-class report")

    # --- each path alone: a step launches the three shears and the four bank layers; a validation
    # --- forward BERT's two kernels 12 times and the bank's 4
    zero_counts()
    trainer.train_step(train[0])
    step_launches = read_counts()
    check(step_launches == {**dict.fromkeys(KERNELS, 0), "shear_sublane": 3, "kan_forward": n_bank},
          f"connext train_step launches {step_launches}")
    zero_counts()
    trainer.validate(val)
    val_launches = read_counts()
    check(val_launches == {**dict.fromkeys(KERNELS, 0), "fused_attention": layers, "ffn_block": layers,
                           "kan_forward": n_bank}, f"connext validation launches {val_launches}")

    # --- the 45-degree shears (pads 49, 82) and the jitter: kernel against plain on the same sampled values
    canv = trainer.to_device(train[1])["image"]
    p = aug.sample_crop_flip_rotate(B, CANVAS, trainer.generator, vflip=True, degrees=45.0)
    j = aug.sample_color_jitter(B, trainer.generator)
    x_kernel = trainer.augment(canv, params=p, jitter=j)
    with _plain_op(aug, "shear_sublane", sh.shear_reference):
        x_plain = trainer.augment(canv, params=p, jitter=j)
    aug_d = diff(x_kernel, x_plain)
    check(aug_d[0] == 0.0 and x_kernel.shape == (B, 3, CONNEXT_CROP, CONNEXT_CROP),
          f"connext augmentation kernel vs plain: {aug_d}, shape {tuple(x_kernel.shape)}")

    # --- one step with the kernel against the same step on kan_forward's plain version
    dev_b = trainer.to_device(train[1])
    valid = trainer.valid_mask(train[1], B)
    with torch.no_grad():
        images = trainer.augment(dev_b["image"])
    noise = torch.randn((B, CONNEXT_HAM.moe_num_experts), generator=g, device=dev)
    groups = {"moe": [p for n, p in trainer.model.named_parameters() if n.startswith("moe.")],
              "text_encoder": list(trainer.model.text_encoder.parameters())}
    step = {}
    for which in ("kernel", "plain"):
        with contextlib.ExitStack() as stack:
            if which == "plain":
                stack.enter_context(_plain_op(ks, "kan_forward", ks.kan_forward_reference))
            torch.manual_seed(seed)
            loss, out = trainer.forward_backward(images, dev_b, valid, noise=noise)
        step[which] = (loss.item(), {k: torch.cat([p.grad.double().flatten() for p in ps]) for k, ps in groups.items()})
    (loss_k, gk), (loss_p, gp) = step["kernel"], step["plain"]
    rel = abs(loss_k - loss_p) / abs(loss_p)
    cos = {k: (gk[k] @ gp[k] / (gk[k].norm() * gp[k].norm() + 1e-30)).item() for k in groups}
    check(rel <= CONNEXT_TRAIN_LOSS_REL and all(c >= CONNEXT_TRAIN_GRAD_COS for c in cos.values()),
          f"connext step vs plain kan_forward: loss {loss_k} vs {loss_p}, gradient cosines {cos}")
    del step, gk, gp

    # --- rates, step parts, the device breakdown
    images_per_s = _images_per_s(trainer, train)
    parts = _step_parts_ms(trainer, train[0])
    device = device_profile(lambda: trainer.train_step(train[0]), parts["step_ms"], reps=2, top=15)
    peak_all_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    emit({"phase": "train_connext", "config": "connext_ham", "model": "ConNexTClassifier: ConvNeXt-base + BERT-base, "
          f"fusion 768, MoE head 4 KAN experts {list(CONNEXT_BANK)} top-2; bf16 module, float32 masters, Adam, "
          f"batch {B}, seq {CONNEXT_SEQ}, canvas 256 -> 224, degrees 45, vflip, colour jitter, ImageNet "
          f"normalisation, layer scales {LAYER_SCALE}", "history": history, "fit_s": fit_s,
          "launches_fit": launches, "launches_train_step": step_launches, "launches_validation_forward": val_launches,
          "run_files": files, "augment_kernel_vs_plain_max_abs": aug_d[0], "shear_pads": [49, 82],
          "step_vs_plain_kan_forward": {"loss_kernel": loss_k, "loss_plain": loss_p, "loss_rel": rel,
                                        "grad_cosine": cos},
          "images_per_s_b32": images_per_s, "step_parts_ms": parts, "device": device,
          "peak_memory_gib_fit": peak_gb, "peak_memory_gib_phase": peak_all_gb})
    del trainer, model, masters
    shutil.rmtree(run_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def _baseline_train_batch(rng, n_valid: int) -> dict:
    """A loader-shaped baseline batch: uint8 canvases, seq-128 tokens, labels and n_valid."""
    b = _request(rng, BASELINE_BATCH, BASELINE_SEQ)
    b["label"] = rng.integers(0, LABELS, BASELINE_BATCH).astype(np.int64)
    b["n_valid"] = np.int32(n_valid)
    return b


def _baseline_trainer(name: str, run_dir: Path, dev) -> Trainer:
    """mdhs_tpu_torch/configs/<name>.json with stain normalisation on, through the config-driven
    Trainer: its seeded full-width model (training.seed), a run directory, the script's batches."""
    cfg = load_config(REPO / "mdhs_tpu_torch" / "configs" / f"{name}.json",
                      overrides=["data.stain_normalization.enabled=true", "training.log_every=1",
                                 "training.log_per_class=true"])
    trainer = Trainer(cfg, "baseline", output_dir=str(run_dir / name), device=dev, setup_data=False)
    p = trainer.preset
    check(p.stain == ((150.0, 140.0, 140.0), (20.0, 20.0, 20.0)) and p.degrees == 45.0 and p.vflip
          and p.color_jitter and p.normalize and p.batch_size == BASELINE_BATCH and p.seq_len == BASELINE_SEQ,
          f"{name} preset {p}")
    return trainer


def _kernel_vs_plain_step(trainer, batch, module, name: str, plain, groups: dict, seed: int, noise=None,
                          more=()) -> dict:
    """One step's loss and gradients with ``module.name`` launching its kernel against the same step
    with it (and each (module, name, plain) of ``more``) routed to its plain version: the same augmented
    batch, dropout masks (torch's seed) and gating noise."""
    dev_b = trainer.to_device(batch)
    valid = trainer.valid_mask(batch, dev_b["label"].shape[0])
    with torch.no_grad():
        images = trainer.augment(dev_b["image"])
    step = {}
    for which in ("kernel", "plain"):
        with contextlib.ExitStack() as stack:
            if which == "plain":
                for m, op, fn in ((module, name, plain), *more):
                    stack.enter_context(_plain_op(m, op, fn))
            torch.manual_seed(seed)
            loss, _ = trainer.forward_backward(images, dev_b, valid, noise=noise)
        step[which] = (loss.item(), {k: torch.cat([p.grad.double().flatten() for p in ps]) for k, ps in groups.items()})
    (loss_k, gk), (loss_p, gp) = step["kernel"], step["plain"]
    rel = abs(loss_k - loss_p) / abs(loss_p)
    cos = {k: (gk[k] @ gp[k] / (gk[k].norm() * gp[k].norm() + 1e-30)).item() for k in groups}
    check(rel <= BASELINE_TRAIN_LOSS_REL and all(c >= BASELINE_TRAIN_GRAD_COS for c in cos.values()),
          f"baseline step vs plain {name}: loss {loss_k} vs {loss_p}, gradient cosines {cos}")
    return {"loss_kernel": loss_k, "loss_plain": loss_p, "loss_rel": rel, "grad_cosine": cos}


def _scan_backward(dev, rng) -> dict:
    """selective_scan's backward at ham_fusion_ssm_v1's shape, (64, 49, 512), N 16: the associative
    scan's VJP recomputed from the inputs (what the op's autograd runs), ms (CUDA events) beside the
    forward kernel's, device ms (profiler; the forward kernel's is the kernels line's, at this
    shape), and the memory it takes above its inputs."""
    B, L, D, N = BASELINE_BATCH, 49, 512, 16
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    args = (f(rng.standard_normal((B, L, D))), f(np.log1p(np.exp(rng.standard_normal((B, L, D))))),
            f(-np.exp(rng.standard_normal((D, N)))), f(rng.standard_normal((B, L, N))),
            f(rng.standard_normal((B, L, N))), f(rng.standard_normal(D)))
    g = f(rng.standard_normal((B, L, D)))
    bwd = lambda: torch.func.vjp(ss.selective_scan_associative, *args)[1](g)  # noqa: E731
    fwd = lambda: ss.selective_scan(*args)  # noqa: E731
    leaves = [a.clone().requires_grad_() for a in args]
    got = torch.autograd.grad(ss.selective_scan(*leaves), leaves, g)
    want = bwd()
    err = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30) for a, b in zip(got, want))
    check(err <= 1e-6, f"selective_scan: the op's backward is not the associative VJP ({err})")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    bwd()
    torch.cuda.synchronize()
    extra_gib = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
    saved = read_counts()
    out = {"shape": [B, L, D, N], "backward_ms": cuda_ms(bwd, reps=10), "backward_device_ms": passes_device_ms(bwd),
           "forward_ms": cuda_ms(fwd),
           "backward_memory_gib_above_inputs": extra_gib, "vs_autograd_max_rel": err}
    # the least a backward could do: read the six inputs and the cotangent once and write the six
    # gradients once (float32), and run the reverse recurrence's ~10 operations a state and step
    out["backward_bound_ms"], out["backward_bound_by"] = _bound(
        4.0 * (5 * B * L * D + 4 * B * L * N + 2 * D * N + 2 * D), 10.0 * B * L * D * N / F32_OPS)
    for name, (wrapper, _, _) in KERNELS.items():
        wrapper.launches = saved[name]
    return out


def phase_train_baseline(dev, seed: int) -> dict:
    """The baseline family trained at full width (ResNet18 + BERT-base at seq 128, batch 64, bf16
    module, float32 masters, AdamW, warmup-cosine, stain normalisation, degrees 45, vflip, colour
    jitter, ImageNet normalisation) through the config-driven Trainer: ham_base.json (base.yml:
    multiscale fusion, GroupKAN head) fit over 2 epochs x 2 steps with a validation batch an epoch;
    ham_fusion_ssm_v1.json (the Mamba fusion: selective_scan's kernel forward, the associative VJP
    backward) and ham_head_moe_v1.json (the KAN-expert MoE head: kan_forward's kernel, plain VJP)
    a step each against the same step on the op's plain version, the MoE's one re-grid; launches,
    rates, step parts, the stain pass, the scan's backward, devices and peak memory. Returns each
    path's launches."""
    rng = np.random.default_rng([seed, 27])  # inputs of its own
    g = torch.Generator(device=dev).manual_seed(seed + 27)
    run_dir = REPO / "mdhs_tpu_torch" / "build" / "train_baseline_smoke"  # git-ignored; removed at the end
    shutil.rmtree(run_dir, ignore_errors=True)
    layers = BertConfig().num_hidden_layers
    train = [_baseline_train_batch(rng, BASELINE_BATCH), _baseline_train_batch(rng, 41)]  # the second short
    val = [_baseline_train_batch(rng, BASELINE_BATCH)]
    out = {}

    # --- ham_base: the main path, Trainer.fit, 2 epochs x 2 steps, validation on one batch an epoch
    torch.cuda.reset_peak_memory_stats(dev)
    trainer = _baseline_trainer("ham_base", run_dir, dev)
    masters = dict(zip((n for n, _ in trainer.model.named_parameters()), trainer.master_parameters()))
    watch = {n: masters[n].detach().clone() for n in ("classifier.kan1.act_coeff", "classifier.kan2.linear.weight",
                                                      "fusion.cross_l4.attn.in_proj_weight",
                                                      "image_encoder.model.conv1.weight",
                                                      "text_encoder.model.encoder.layer.0.attention.self.query.weight")}
    zero_counts()
    t0 = time.perf_counter()
    history = trainer.fit(train, val, num_epochs=2, steps_per_epoch=2)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    want = {**dict.fromkeys(KERNELS, 0), "shear_sublane": 3 * 4, "attention_block": layers * 2,
            "ffn_block": layers * 2}
    check(launches == want, f"train_baseline fit launches {launches}, expected {want}")
    losses = [x for h in history for x in h["train_losses"]] + [h["val_loss"] for h in history]
    check(all(np.isfinite(losses)), f"non-finite baseline losses {losses}")
    check(all(not torch.equal(p, masters[n]) for n, p in watch.items()), "baseline parameters unchanged")
    files = _run_files(str(run_dir / "ham_base"))
    check("per_class/f1_class_6" in files["tags"], "no per-class report")
    zero_counts()
    trainer.train_step(train[0])
    step_launches = read_counts()
    check(step_launches == {**dict.fromkeys(KERNELS, 0), "shear_sublane": 3}, f"ham_base step {step_launches}")
    canv = trainer.to_device(train[1])["image"]
    p = aug.sample_crop_flip_rotate(BASELINE_BATCH, CANVAS, trainer.generator, vflip=True, degrees=45.0)
    j = aug.sample_color_jitter(BASELINE_BATCH, trainer.generator)
    x_kernel = trainer.augment(canv, params=p, jitter=j)
    with _plain_op(aug, "shear_sublane", sh.shear_reference):
        x_plain = trainer.augment(canv, params=p, jitter=j)
    aug_d = diff(x_kernel, x_plain)
    check(aug_d[0] == 0.0 and x_kernel.shape == (BASELINE_BATCH, 3, 224, 224),
          f"baseline augmentation kernel vs plain: {aug_d}")
    x01 = canv.float() / 255.0
    stain = {"ms": cuda_ms(lambda: stain_normalize(x01)), "device_ms": passes_device_ms(lambda: stain_normalize(x01)),
             "bound_ms": _bound(2 * x01.numel() * 4, 0.0)[0], "shape": list(x01.shape)}
    images_per_s = _images_per_s(trainer, train)
    parts = _step_parts_ms(trainer, train[0])
    device = device_profile(lambda: trainer.train_step(train[0]), parts["step_ms"], reps=2, top=15)
    peak_all_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    out["ham_base"] = {"config": "ham_base (configs/common/base.yml)", "history": history, "fit_s": fit_s,
                       "launches_fit": launches, "launches_train_step": step_launches, "run_files": files,
                       "augment_kernel_vs_plain_max_abs": aug_d[0], "stain_pass": stain,
                       "images_per_s_b64": images_per_s, "step_parts_ms": parts, "device": device,
                       "peak_memory_gib_fit": peak_gb, "peak_memory_gib_phase": peak_all_gb}
    result = {"train_baseline": launches}
    del trainer, masters, watch
    torch.cuda.empty_cache()

    # --- ham_fusion_ssm_v1 and ham_head_moe_v1: a step and a validation forward each, the step against
    # --- the op's plain version, their step parts; the MoE's one re-grid
    for name, module, kernel, plain, per, group in (
            ("ham_fusion_ssm_v1", ss, "selective_scan", ss.selective_scan_reference, 1, "fusion.mamba."),
            ("ham_head_moe_v1", ks, "kan_forward", ks.kan_forward_reference, 2, "classifier.moe.")):
        trainer = _baseline_trainer(name, run_dir, dev)
        noise = None
        if kernel == "kan_forward":
            trainer.model.eval()
            _route_rows_apart(trainer.model, train[0], dev, g)  # w_gate is its own float32 master
            trainer.model.train()
            noise = torch.randn((BASELINE_BATCH, HAM_HEAD_MOE.moe_num_experts), generator=g, device=dev)
        zero_counts()
        trainer.train_step(train[0])
        step_launches = read_counts()
        check(step_launches == {**dict.fromkeys(KERNELS, 0), "shear_sublane": 3, kernel: per},
              f"{name} train_step launches {step_launches}")
        zero_counts()
        val_loss, _ = trainer.validate(val)
        val_launches = read_counts()
        check(val_launches == {**dict.fromkeys(KERNELS, 0), "attention_block": layers, "ffn_block": layers,
                               kernel: per} and np.isfinite(val_loss), f"{name} validation launches {val_launches}")
        groups = {group.rstrip("."): [p for n, p in trainer.model.named_parameters() if n.startswith(group)],
                  "text_encoder": list(trainer.model.text_encoder.parameters())}
        vs_plain = _kernel_vs_plain_step(trainer, train[1], module, kernel, plain, groups, seed, noise)
        rec = {"config": name, "launches_train_step": step_launches, "launches_validation_forward": val_launches,
               f"step_vs_plain_{kernel}": vs_plain, "step_parts_ms": _step_parts_ms(trainer, train[0], reps=3)}
        result[f"train_baseline_{'ssm' if kernel == 'selective_scan' else 'moe'}"] = {
            k: step_launches[k] + val_launches[k] for k in KERNELS}
        if kernel == "kan_forward":
            moe = trainer.model.classifier.moe
            grid0 = moe.experts[0].layers[0].grid.clone()
            with torch.no_grad():
                trainer.model.eval()
                before = trainer._val_pass(val, True)[2][0][0]
                zero_counts()
                n = trainer._kan_regrid(train[0])
                regrid_launches = read_counts()
                trainer.model.eval()
                after = trainer._val_pass(val, True)[2][0][0]
            trainer.model.train()
            check(n == 2 and not torch.equal(grid0, moe.experts[0].layers[0].grid)
                  and torch.equal(moe.stacked_layers()[0][0][0], moe.experts[0].layers[0].grid)
                  and regrid_launches == {**dict.fromkeys(KERNELS, 0), "attention_block": layers,
                                          "ffn_block": layers, "kan_forward": per}
                  and bool(torch.isfinite(after).all()), f"{name} re-grid: {n} layers, launches {regrid_launches}")
            rec["regrid"] = {"layers": n, "launches": regrid_launches,
                             "val_logits_change_max_abs": (after - before).abs().max().item(),
                             "val_logits_max_abs": before.abs().max().item()}
            result["train_baseline_moe"] = {k: result["train_baseline_moe"][k] + regrid_launches[k] for k in KERNELS}
        else:
            rec["scan_backward"] = _scan_backward(dev, rng)
        out[name] = rec
        del trainer
        torch.cuda.empty_cache()
    emit({"phase": "train_baseline", "model": "MultimodalBaselineModel: ResNet18 + BERT-base at seq 128, hidden 256, "
          f"batch {BASELINE_BATCH}; bf16 module, float32 masters, AdamW, warmup-cosine, canvas 256 -> 224, stain "
          "normalisation, degrees 45, vflip, colour jitter, ImageNet normalisation", **out})
    shutil.rmtree(run_dir, ignore_errors=True)
    return result


# ---------------------------------------------------------------------------
# phase 13: the inference entry points over an image directory and a checkpoint
REPO = Path(__file__).resolve().parent
CLI_DIR = REPO / "mdhs_tpu_torch" / "build" / "cli_smoke"  # git-ignored; removed when the phase ends


def _cli_image(rng) -> np.ndarray:
    """A seeded 450 x 600 RGB image: a skin-toned field, a darker blob, pixel noise."""
    yy, xx = np.arange(CLI_H, dtype=np.float32)[:, None], np.arange(CLI_W, dtype=np.float32)[None, :]
    cy, cx, r = rng.uniform(0.3, 0.7) * CLI_H, rng.uniform(0.3, 0.7) * CLI_W, rng.uniform(60, 160)
    # separable: exp(-(dy^2 + dx^2) / 2r^2) = exp(-dy^2 / 2r^2) exp(-dx^2 / 2r^2)
    blob = (np.exp(-(yy - cy) ** 2 / (2 * r * r)) * np.exp(-(xx - cx) ** 2 / (2 * r * r)))[..., None]
    img = rng.uniform(150, 230, 3) * (1 - blob) + rng.uniform(30, 120, 3) * blob
    return np.clip(img + rng.normal(0, 6, (CLI_H, CLI_W, 3)), 0, 255).astype(np.uint8)


def _cli_inputs(rng) -> dict:
    """CLI_IMAGES PNGs, a JSON of their descriptions (8-300 words: some past seq 256),
    and label CSVs of the first 80, 64 and 32 rows of a shuffled order."""
    img_dir = CLI_DIR / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    names = [f"ISIC_{i:07d}.png" for i in range(CLI_IMAGES)]
    records = []
    for name in names:
        png.write_png(str(img_dir / name), _cli_image(rng))
        records.append({"image_info": name, "description": " ".join(rng.choice(CLI_WORDS, int(rng.integers(8, 300))))})
    (CLI_DIR / "descriptions.json").write_text(json.dumps(records))
    order = [names[i] for i in rng.permutation(CLI_IMAGES)]
    labels = {name: int(rng.integers(0, LABELS)) for name in names}
    csvs = {}
    for n in (CLI_IMAGES, 64, 32):
        csvs[n] = str(CLI_DIR / f"labels_{n}.csv")
        Path(csvs[n]).write_text("image_id,label\n" + "".join(f"{a},{labels[a]}\n" for a in order[:n]))
    return {"image_dir": str(img_dir), "json_path": str(CLI_DIR / "descriptions.json"), "label_csv": csvs,
            "order": order, "labels": labels}


def _cli_config(name: str, inputs: dict, n: int) -> str:
    """mdhs_tpu_torch/configs/<name>.json (a configs/*.yml resolved) with its test split at
    the inputs' first n rows, written as JSON; its path."""
    cfg = load_config(REPO / "mdhs_tpu_torch" / "configs" / f"{name}.json")
    for key, val in (("data.test_image_dir", inputs["image_dir"]), ("data.test_json_path", inputs["json_path"]),
                     ("data.test_label_csv", inputs["label_csv"][n]), ("output.log_dir", str(CLI_DIR / "runs"))):
        cfg.set(key, val)
    path = CLI_DIR / f"{name}_{n}.json"
    cfg.save_json(path)
    return str(path)


def _cli_checkpoint(model: nn.Module, name: str) -> str:
    """``model``'s seeded weights as a port checkpoint, checked to reload bit for bit; its path."""
    path = str(CLI_DIR / f"{name}.pt")
    save_checkpoint(path, model, {"name": name})
    saved, state = load_torch_file(path), model.state_dict()
    check(saved.keys() == state.keys() and all(torch.equal(saved[k], state[k].cpu()) for k in state),
          f"{name}: the checkpoint does not reload bit for bit")
    return path


def _cli_run(fn, argv: list, n: int) -> tuple:
    """One CLI call with every count at 0 just before it: (its result, the kernels'
    launches, host-clock seconds and images/s, the host's decode / resize / tokenize ms,
    the PNG reader's and the native resampler's calls)."""
    zero_counts()
    cli_data.reset_host_ms()
    png.decode_png.calls = native.resize_center_square.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn([*argv, "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return result, read_counts(), {"seconds": seconds, "images_per_s": n / seconds,
                                   "host_ms": dict(cli_data.HOST_MS), "png_decodes": png.decode_png.calls,
                                   "native_resizes": native.resize_center_square.calls}


def _cli_check_run(what: str, launches: dict, want: dict, info: dict, n: int, png_reader: bool) -> None:
    """The run's launches, and its n images each resized by the native resampler and, where
    ``png_reader`` (PIL set aside, or absent), decoded by data/png.py."""
    want = {**dict.fromkeys(KERNELS, 0), **want}
    check(launches == want, f"cli {what}: launches {launches}, expected {want}")
    check(info["native_resizes"] == n, f"cli {what}: the native resampler ran {info['native_resizes']} times, not {n}")
    decodes = n if png_reader or cli_data._pil() is None else 0
    check(info["png_decodes"] == decodes, f"cli {what}: the PNG reader ran {info['png_decodes']} times, not {decodes}")


@contextlib.contextmanager
def _without_pil():
    """The dataset as on a machine without PIL: every PNG through data/png.py."""
    pil = cli_data._pil
    cli_data._pil = lambda: None
    try:
        yield
    finally:
        cli_data._pil = pil


def _cli_device(model, batch, dev, image_size, normalize, tta=(), **forward_kwargs) -> dict:
    """The forward of one loader batch (fused over the TTA variants where asked): its
    CUDA-event ms and its device breakdown."""
    with torch.inference_mode():
        img = eval_pipeline(torch.from_numpy(batch["image"]).to(dev), image_size, normalize=normalize,
                            dtype=model.input_dtype)
        ids = torch.from_numpy(batch["input_ids"]).long().to(dev)
        mask = torch.from_numpy(batch["attention_mask"]).long().to(dev)
        if tta:
            V = len(tta) + 1
            img = tta_variants(img, tta).flatten(0, 1).contiguous(memory_format=torch.channels_last)
            ids, mask = ids.repeat(V, 1), mask.repeat(V, 1)
        fwd = lambda: model(img, ids, mask, **forward_kwargs)  # noqa: E731
        ms = cuda_ms(fwd, reps=5)
        return {"forward_ms": ms, "rows": int(img.shape[0]), "device": device_profile(fwd, ms)}


def _cli_model(cfg: str, family: str, ckpt: str, dev):
    """The model and the first loader batch of a CLI run, outside the CLI."""
    predictor = cli_common.build_predictor(cfg, family, device=dev)
    predictor.load_weights(ckpt)
    return predictor.model.to(memory_format=torch.channels_last), next(iter(predictor.make_test_loader()))


def _cli_busy(info: dict, device: dict, forwards: int) -> None:
    """The device's busy share of the CLI call: its forwards' device ms over the call's host-clock ms."""
    info["device_ms_per_forward"] = device["device"]["kernel_ms"]
    info["busy_share"] = device["device"]["kernel_ms"] * forwards / (info["seconds"] * 1e3)


def _logits_of(server, batches) -> np.ndarray:
    return np.concatenate([server.predict(b)[: int(b["n_valid"])] for b in batches])


def _judge_model(out, ref, atol, mean, what) -> dict:
    mx, mn = diff(torch.from_numpy(out), torch.from_numpy(ref))
    check(mx <= atol and mn < mean, f"cli {what}: max {mx} mean {mn} (bound {atol} / {mean})")
    return {"max_abs": mx, "mean_abs": mn}


def _cli_mibf(dev, inputs: dict, g) -> dict:
    """run_predict (TTA off, then on) and run_evaluate on mibf_ham at full width, and the preset
    on the same images and weights; returns the phase's MIBF lines and their launches."""
    n = CLI_IMAGES
    layers = BertConfig().num_hidden_layers
    batches_n = -(-n // BATCH)
    ckpt = _cli_checkpoint(init_parameters(MIBFNet(LABELS, BertConfig(), device=dev), g), "mibf_ham")
    torch.cuda.empty_cache()
    cfg = _cli_config("mibf_ham", inputs, n)
    base = ["--config", cfg, "--model_path", ckpt, "--family", "mibf"]
    csv_path = str(CLI_DIR / "submission.csv")
    out = {}
    want = {"attention_block": layers * batches_n, "ffn_block": layers * batches_n}

    pred, launches, info = _cli_run(run_predict.main, [*base, "--output_path", csv_path], n)
    _cli_check_run("mibf predict", launches, want, info, n, False)
    logits = pred["logits"]
    check(logits.shape == (n, LABELS) and bool(np.isfinite(logits).all()), f"cli mibf logits {logits.shape}")
    rows = [line.split(",") for line in Path(csv_path).read_text().splitlines()]
    check(rows[0] == ["image_id", "predicted_label"] and [r[0] for r in rows[1:]] == inputs["order"]
          and [int(r[1]) for r in rows[1:]] == logits.argmax(-1).tolist(),
          "cli mibf: the CSV is not the label CSV's rows in order with the logits' argmax")
    csv_accuracy = 100.0 * float(np.mean([int(r[1]) == inputs["labels"][r[0]] for r in rows[1:]]))
    out["predict"], out["launches"] = info, {"predict": launches}

    tta_set = ["--set", "inference.tta.enabled=true", "--set", f"inference.tta.transforms=[{','.join(CLI_TTA)}]"]
    csv_tta = str(CLI_DIR / "submission_tta.csv")
    tta_pred, launches, info = _cli_run(run_predict.main, [*base, "--output_path", csv_tta, *tta_set], n)
    _cli_check_run("mibf predict with TTA", launches, want, info, n, False)
    out["predict_tta"], out["launches"]["predict_tta"] = info, launches

    with _without_pil():  # this run decodes its PNGs with data/png.py, as a machine without PIL does
        report, launches, info = _cli_run(run_evaluate.main, base, n)
    _cli_check_run("mibf evaluate", launches, want, info, n, True)
    check(report["num_samples"] == n and abs(report["accuracy"] - csv_accuracy) < 1e-4,  # a float32 fraction
          f"cli mibf: evaluate accuracy {report['accuracy']} against the CSV's {csv_accuracy}")
    out["evaluate"], out["launches"]["evaluate"] = info, launches
    out["accuracy"] = report["accuracy"]

    # --- the same checkpoint and canvases outside the CLI --------------------
    predictor = cli_common.build_predictor(cfg, "mibf", device=dev)
    predictor.load_weights(ckpt)
    batches = list(predictor.make_test_loader())
    with _without_pil():
        png_batches = list(predictor.make_test_loader())
    check(all(np.array_equal(a["image"], b["image"]) for a, b in zip(batches, png_batches)),
          "cli mibf: the canvases of data/png.py's decode differ from PIL's")
    server = ServingModel(predictor.model, BATCH, dev)
    served = _logits_of(server, batches)
    check(np.array_equal(served, logits), "cli mibf: the logits differ from ServingModel.predict's on the same "
          f"checkpoint and canvases (max |d| {np.abs(served - logits).max()})")
    plain = build_model(load_config(cfg, overrides=["model.text_encoder.attention_impl=xla"]), "mibf",
                        predictor.tokenizer, device=dev)
    load_weights(plain, ckpt, "mibf")
    out["logits_vs_plain"] = _judge_model(logits, _logits_of(ServingModel(plain, BATCH, dev), batches),
                                          SLICE_ATOL, SLICE_MEAN, "mibf logits against the plain path")
    separate = []
    with torch.inference_mode():
        for b in batches:
            img = eval_pipeline(torch.from_numpy(b["image"]).to(dev), 224, normalize=False, dtype=torch.bfloat16)
            ids = torch.from_numpy(b["input_ids"]).long().to(dev)
            mask = torch.from_numpy(b["attention_mask"]).long().to(dev)
            variants = [predictor.model(v.contiguous(memory_format=torch.channels_last), ids, mask)["image_text"]
                        for v in tta_variants(img, CLI_TTA)]
            separate.append(torch.stack(variants).mean(dim=0)[: int(b["n_valid"])].cpu().numpy())
    out["tta_vs_separate_forwards"] = _judge_model(tta_pred["logits"], np.concatenate(separate), SLICE_ATOL,
                                                   SLICE_MEAN, "mibf TTA logits against four separate forwards")
    t0 = time.perf_counter()
    cli_common.run_prediction(predictor, predictor.make_test_loader())
    torch.cuda.synchronize()
    out["loop_images_per_s"] = n / (time.perf_counter() - t0)  # decode + resize + tokenize + forward, no model load
    out["device_b32"] = _cli_device(predictor.model, batches[0], dev, 224, False)
    out["device_b32_tta"] = _cli_device(predictor.model, batches[0], dev, 224, False, CLI_TTA)
    for run in ("predict", "evaluate"):
        _cli_busy(out[run], out["device_b32"], batches_n)
    _cli_busy(out["predict_tta"], out["device_b32_tta"], batches_n)
    del predictor, server, plain
    torch.cuda.empty_cache()

    # --- the int8 serving preset on the same images and weights --------------
    cfg_q = _cli_config("mibf_ham_serving", inputs, n)
    q_pred, launches, info = _cli_run(run_predict.main, ["--config", cfg_q, "--model_path", ckpt, "--family", "mibf",
                                                         "--output_path", str(CLI_DIR / "preset.csv")], n)
    _cli_check_run("preset predict", launches,
                   {"int8_attention_block": layers * batches_n, "int8_ffn_block": layers * batches_n}, info, n, False)
    predictor = cli_common.build_predictor(cfg_q, "mibf", device=dev)
    predictor.load_weights(ckpt)
    with int8_composite():
        composite = _logits_of(ServingModel(predictor.model, BATCH, dev), batches)
    preset = {"run": info, "launches": launches,
              "logits_vs_int8_composite": _judge_model(q_pred["logits"], composite, INT8_ATOL, INT8_MEAN,
                                                       "preset logits against the int8 composite"),
              "device_b32": _cli_device(predictor.model, batches[0], dev, 224, False)}
    _cli_busy(preset["run"], preset["device_b32"], batches_n)
    del predictor
    torch.cuda.empty_cache()
    return {"mibf": out, "preset": preset, "made": {"mibf_ham": (cfg, ckpt), "mibf_ham_serving": (cfg_q, ckpt),
                                                      "mibf_ham_tta_csv": csv_tta}}


def phase_cli(dev, seed: int) -> tuple[dict, dict]:
    """The three CLIs on the card over a PNG directory and port checkpoints; returns each
    path's launches, and the configs and checkpoints it made (in CLI_DIR, which the caller
    removes) for phase_export."""
    rng = np.random.default_rng([seed, 30])  # inputs of its own: the other phases' stay as they were
    g = torch.Generator(device=dev).manual_seed(seed + 30)
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    check(native.available(), "the native library (native/*.cpp) did not build")
    native_build_s = time.perf_counter() - t0
    inputs = _cli_inputs(rng)
    mibf = _cli_mibf(dev, inputs, g)
    layers = BertConfig().num_hidden_layers

    # --- run_ablation_eval on ham_fusion_ssm_v1: batch 64, one batch of 64 images
    ckpt = _cli_checkpoint(init_parameters(MultimodalBaselineModel(HAM_FUSION_SSM, device=dev), g),
                           "ham_fusion_ssm_v1")
    torch.cuda.empty_cache()
    results_path = str(CLI_DIR / "ablation.yml")
    cfg = _cli_config("ham_fusion_ssm_v1", inputs, 64)
    results, launches, info = _cli_run(run_ablation_eval.main, ["--config", cfg, "--model_path", ckpt,
                                                                "--output", results_path], 64)
    # full_fusion and text_off run BERT and the fusion (one scan each); image_only neither
    _cli_check_run("ablation", launches, {"attention_block": 2 * layers, "ffn_block": 2 * layers,
                                          "selective_scan": 2}, info, 64, False)
    text = Path(results_path).read_text()
    check(list(results) == list(run_ablation_eval.MODES)
          and all(f"  {k}: {v!r}" in text.splitlines() for k, v in results.items()),
          f"cli ablation results {results} against the file:\n{text}")
    model, batch = _cli_model(cfg, "baseline", ckpt, dev)
    ablation = {"run": info, "launches": launches, "results": results,
                "device_b64": {mode or "full_fusion": _cli_device(model, batch, dev, 224, True, ablation_mode=mode)
                               for mode in run_ablation_eval.MODES.values()}}
    info["device_ms_per_forward"] = {k: v["device"]["kernel_ms"] for k, v in ablation["device_b64"].items()}
    info["busy_share"] = sum(info["device_ms_per_forward"].values()) / (info["seconds"] * 1e3)
    made = {**mibf["made"], "ham_fusion_ssm_v1": (cfg, ckpt)}
    del model
    torch.cuda.empty_cache()

    # --- run_predict --family connext on connext_ham: batch 32, seq 512, 32 images
    ckpt = _cli_checkpoint(init_parameters(ConNexTClassifier(CONNEXT_HAM, device=dev), g), "connext_ham")
    torch.cuda.empty_cache()
    cfg = _cli_config("connext_ham", inputs, 32)
    c_pred, launches, info = _cli_run(run_predict.main, ["--config", cfg, "--model_path", ckpt, "--family",
                                                         "connext", "--output_path", str(CLI_DIR / "connext.csv")], 32)
    n_bank = len(CONNEXT_BANK) - 1
    _cli_check_run("connext predict", launches, {"fused_attention": layers, "ffn_block": layers,
                                                 "kan_forward": n_bank}, info, 32, False)
    check(c_pred["logits"].shape == (32, CONNEXT_HAM.num_labels) and bool(np.isfinite(c_pred["logits"]).all()),
          f"cli connext logits {c_pred['logits'].shape}")
    model, batch = _cli_model(cfg, "connext", ckpt, dev)
    connext = {"run": info, "launches": launches, "device_b32": _cli_device(model, batch, dev, 224, True)}
    _cli_busy(info, connext["device_b32"], 1)
    made["connext_ham"] = (cfg, ckpt)
    made["inputs"] = inputs
    del model
    torch.cuda.empty_cache()
    emit({"phase": "cli", "images": CLI_IMAGES, "image_hw": [CLI_H, CLI_W], "pil": cli_data._pil() is not None,
          "native_build_s": native_build_s, "host_modules": {name: importlib.util.find_spec(name) is not None
                                                             for name in ("PIL", "yaml", "msgpack")},
          "mibf_ham": mibf["mibf"], "mibf_ham_serving": mibf["preset"], "ham_fusion_ssm_v1": ablation,
          "connext_ham": connext})
    return {"cli_mibf": {k: sum(run[k] for run in mibf["mibf"]["launches"].values()) for k in KERNELS},
            "cli_preset": mibf["preset"]["launches"], "cli_ablation": ablation["launches"],
            "cli_connext": connext["launches"]}, made


@contextlib.contextmanager
def _saved_checkpoints(into: dict):
    """Every TopKCheckpointManager.maybe_save's state, kept by epoch (their tensors are host copies)."""
    real = TopKCheckpointManager.maybe_save

    def spy(self, epoch, metric, state):
        into[epoch] = state["state_dict"]
        return real(self, epoch, metric, state)

    TopKCheckpointManager.maybe_save = spy
    try:
        yield into
    finally:
        TopKCheckpointManager.maybe_save = real


def phase_train_cli(dev, inputs: dict, g) -> dict:
    """python3 -m mdhs_tpu_torch.cli.run_train --family mibf on mibf_ham (batch 32, seq 256) over
    phase_cli's PNGs: 64 train images, 16 val images, 2 epochs from a seeded full-width start
    (model.pretrained_path); the run directory, the launches of the run, the best checkpoint
    against the trainer's state at its epoch and through run_predict, and a resume for one more
    epoch; returns the launches of the two runs."""
    layers = BertConfig().num_hidden_layers
    order = inputs["order"]
    val_csv = CLI_DIR / "labels_val16.csv"
    val_csv.write_text("image_id,label\n" + "".join(f"{a},{inputs['labels'][a]}\n" for a in order[64:80]))
    init = _cli_checkpoint(_damp_residual_branches(init_parameters(MIBFNet(LABELS, BertConfig(), device=dev), g)),
                           "mibf_train_init")
    cfg = load_config(REPO / "mdhs_tpu_torch" / "configs" / "mibf_ham.json")
    for key, val in (("data.train_image_dir", inputs["image_dir"]), ("data.train_json_path", inputs["json_path"]),
                     ("data.train_label_csv", inputs["label_csv"][64]), ("data.val_image_dir", inputs["image_dir"]),
                     ("data.val_json_path", inputs["json_path"]), ("data.val_label_csv", str(val_csv)),
                     ("data.test_image_dir", inputs["image_dir"]), ("data.test_json_path", inputs["json_path"]),
                     ("data.test_label_csv", str(val_csv)), ("output.log_dir", str(CLI_DIR / "train_runs")),
                     ("output.run_name", "mibf_ham"), ("model.pretrained_path", init), ("training.num_epochs", 2),
                     ("training.log_every", 1)):
        cfg.set(key, val)
    cfg_path = str(CLI_DIR / "mibf_ham_train.json")
    cfg.save_json(cfg_path)
    argv = ["--config", cfg_path, "--family", "mibf"]

    saved = {}
    with _saved_checkpoints(saved):
        trainer, launches, info = _cli_run(run_train.main, argv, 64 * 2)
    steps, val_batches = 2 * 2, 2
    want = {"shear_sublane": 3 * steps, "attention_block": layers * val_batches, "ffn_block": layers * val_batches}
    check(launches == {**dict.fromkeys(KERNELS, 0), **want}, f"train cli launches {launches}, expected {want}")
    out = trainer.output_dir
    files = _run_files(out)
    check(trainer.step == steps and trainer.epoch == 2, f"train cli: step {trainer.step}, epoch {trainer.epoch}")
    losses = [r["value"] for r in map(json.loads, Path(out, "metrics.jsonl").read_text().splitlines())
              if r["tag"].startswith("Loss/")]

    # --- the best checkpoint: the trainer's state at its epoch, bit for bit, in the file and in a fresh model
    best = Path(out, files["checkpoints"][0]["path"])
    epoch = int(re.match(r"epoch_(\d+)_", best.name).group(1))
    on_disk = load_torch_file(str(best))
    check(on_disk.keys() == saved[epoch].keys() and all(torch.equal(on_disk[k], saved[epoch][k]) for k in on_disk),
          f"train cli: {best.name} differs from the trainer's state at epoch {epoch}")
    fresh = MIBFNet(LABELS, BertConfig(), device=dev)
    load_weights(fresh, str(best), "mibf")
    check(all(torch.equal(v.cpu(), on_disk[k]) for k, v in fresh.state_dict().items()),
          "train cli: the best checkpoint does not reload bit for bit")
    del fresh

    # --- run_predict over the val images with the best checkpoint against the trainer's eval forward on them
    pred, p_launches, p_info = _cli_run(run_predict.main, ["--config", cfg_path, "--model_path", str(best),
                                                           "--family", "mibf",
                                                           "--output_path", str(CLI_DIR / "train_best.csv")], 16)
    check(p_launches == {**dict.fromkeys(KERNELS, 0), "attention_block": layers, "ffn_block": layers},
          f"train cli predict launches {p_launches}")
    trainer.load_weights(str(best))
    trainer.model.eval()
    ref = []
    with torch.inference_mode():
        for b in trainer.val_loader:
            d = trainer.to_device(b)
            img = eval_pipeline(d["image"], 224, normalize=False, dtype=trainer.dtype)
            ref.append(trainer.model(img, d["input_ids"], d["attention_mask"])["image_text"][: int(b["n_valid"])])
    ref = torch.cat(ref).float().cpu().numpy()
    predict_vs_trainer = _judge_model(pred["logits"], ref, SLICE_ATOL, SLICE_MEAN,
                                      "run_predict over the best checkpoint against the trainer's eval forward")
    predict_vs_trainer["bit_equal"] = bool(np.array_equal(pred["logits"], ref))
    last_state = torch.load(str(Path(out, "last.pt")), map_location="cpu", weights_only=True)["resume"]
    del trainer
    torch.cuda.empty_cache()

    # --- a resume from last.pt for one more epoch: it starts at the saved step and schedule position
    resumed, r_launches, r_info = _cli_run(run_train.main, [*argv, "--set", f"training.resume_from={out}/last.pt",
                                                            "--set", "training.num_epochs=3"], 64)
    check(r_launches == {**dict.fromkeys(KERNELS, 0), "shear_sublane": 3 * 2, "attention_block": layers,
                         "ffn_block": layers}, f"train cli resume launches {r_launches}")
    check(last_state["step"] == steps and resumed.step == steps + 2 and resumed.epoch == 3,
          f"train cli resume: saved step {last_state['step']}, now {resumed.step}, epoch {resumed.epoch}")
    r_recs = [json.loads(line) for line in Path(resumed.output_dir, "metrics.jsonl").read_text().splitlines()]
    lr = [r["value"] for r in r_recs if r["tag"] == "LearningRate"]
    check([r["step"] for r in r_recs if r["tag"] == "Loss/Train_Epoch"] == [3]
          and lr == [resumed.lr_schedule(steps + 2)], f"train cli resume records {r_recs}")
    del resumed
    torch.cuda.empty_cache()
    emit({"phase": "train_cli", "config": "mibf_ham", "train_images": 64, "val_images": 16,
          "run": info, "launches": launches, "run_files": files, "losses": losses, "best": best.name,
          "best_epoch": epoch, "predict": p_info, "predict_vs_trainer_eval": predict_vs_trainer,
          "resume": {"run": r_info, "launches": r_launches, "saved_step": last_state["step"],
                     "learning_rate_epoch_3": lr}})
    return {"train_cli": {k: launches[k] + r_launches[k] for k in KERNELS}}


def phase_train_baseline_cli(dev, inputs: dict) -> dict:
    """python3 -m mdhs_tpu_torch.cli.run_train (the family defaulting to baseline) on ham_base.json
    (batch 64, seq 128, stain normalisation on) over phase_cli's PNGs: 64 train images, 16 val images,
    2 epochs from the seeded init; the run directory, the launches of the run, the best checkpoint
    against the trainer's state at its epoch, and run_predict (the family defaulting to baseline)
    over it against the trainer's eval forward; returns the launches of the two runs."""
    layers = BertConfig().num_hidden_layers
    order = inputs["order"]
    val_csv = CLI_DIR / "labels_val16.csv"  # train_cli's: the 16 images after the 64
    val_csv.write_text("image_id,label\n" + "".join(f"{a},{inputs['labels'][a]}\n" for a in order[64:80]))
    cfg = load_config(REPO / "mdhs_tpu_torch" / "configs" / "ham_base.json")
    for key, val in (("data.train_image_dir", inputs["image_dir"]), ("data.train_json_path", inputs["json_path"]),
                     ("data.train_label_csv", inputs["label_csv"][64]), ("data.val_image_dir", inputs["image_dir"]),
                     ("data.val_json_path", inputs["json_path"]), ("data.val_label_csv", str(val_csv)),
                     ("data.test_image_dir", inputs["image_dir"]), ("data.test_json_path", inputs["json_path"]),
                     ("data.test_label_csv", str(val_csv)), ("output.log_dir", str(CLI_DIR / "train_runs")),
                     ("output.run_name", "ham_base"), ("training.num_epochs", 2), ("training.log_every", 1),
                     ("data.stain_normalization", {"enabled": True})):
        cfg.set(key, val)
    cfg_path = str(CLI_DIR / "ham_base_train.json")
    cfg.save_json(cfg_path)
    saved = {}
    with _saved_checkpoints(saved):
        trainer, launches, info = _cli_run(run_train.main, ["--config", cfg_path], 64 * 2)
    want = {"shear_sublane": 3 * 2, "attention_block": layers * 2, "ffn_block": layers * 2}
    check(trainer.family == "baseline" and launches == {**dict.fromkeys(KERNELS, 0), **want},
          f"train baseline cli: family {trainer.family}, launches {launches}, expected {want}")
    out = trainer.output_dir
    files = _run_files(out)
    check(trainer.step == 2 and trainer.epoch == 2, f"train baseline cli: step {trainer.step}, epoch {trainer.epoch}")
    best = Path(out, files["checkpoints"][0]["path"])
    epoch = int(re.match(r"epoch_(\d+)_", best.name).group(1))
    on_disk = load_torch_file(str(best))
    check(on_disk.keys() == saved[epoch].keys() and all(torch.equal(on_disk[k], saved[epoch][k]) for k in on_disk),
          f"train baseline cli: {best.name} differs from the trainer's state at epoch {epoch}")
    pred, p_launches, p_info = _cli_run(run_predict.main, ["--config", cfg_path, "--model_path", str(best),
                                                           "--output_path", str(CLI_DIR / "ham_base_best.csv")], 16)
    check(p_launches == {**dict.fromkeys(KERNELS, 0), "attention_block": layers, "ffn_block": layers},
          f"train baseline cli predict launches {p_launches}")
    trainer.load_weights(str(best))
    trainer.model.eval()
    ref = []
    with torch.inference_mode():
        for b in trainer.val_loader:
            d = trainer.to_device(b)
            img = eval_pipeline(d["image"], 224, normalize=True, dtype=trainer.dtype)
            ref.append(trainer.model(img, d["input_ids"], d["attention_mask"])[: int(b["n_valid"])])
    ref = torch.cat(ref).float().cpu().numpy()
    predict_vs_trainer = _judge_model(pred["logits"], ref, SLICE_ATOL, SLICE_MEAN,
                                      "run_predict over the baseline's best checkpoint against the trainer's eval forward")
    predict_vs_trainer["bit_equal"] = bool(np.array_equal(pred["logits"], ref))
    del trainer
    torch.cuda.empty_cache()
    emit({"phase": "train_baseline_cli", "config": "ham_base", "train_images": 64, "val_images": 16, "run": info,
          "launches": launches, "run_files": files, "best": best.name, "best_epoch": epoch, "predict": p_info,
          "predict_launches": p_launches, "predict_vs_trainer_eval": predict_vs_trainer})
    return {"train_baseline_cli": {k: launches[k] + p_launches[k] for k in KERNELS}}


EXPORT_DIR = REPO / "mdhs_tpu_torch" / "build" / "export_smoke"  # git-ignored; removed when the phase ends
# the artifacts: (CLI config made by phase_cli, family, static batch, export_serving's extra flags,
# launches a forward). Full width and depth.
EXPORT_CASES = {
    "preset": ("mibf_ham_serving", "mibf", 512, [], {"int8_attention_block": 12, "int8_ffn_block": 12}),
    "mibf_tta": ("mibf_ham", "mibf", 32, ["--tta"], {"attention_block": 12, "ffn_block": 12}),
    # the batch-1 p50 of section 2 of PERF.md, live and artifact: the exact model at a static batch of 1
    "mibf_b1": ("mibf_ham", "mibf", 1, [], {"attention_block": 12, "ffn_block": 12}),
    "flash": ("mibf_ham", "mibf", 32, ["--set", "model.text_encoder.attention_impl=flash",
                                       "--set", "tokenizer.max_length=512"], {"flash_attention": 12}),
    "baseline_ssm": ("ham_fusion_ssm_v1", "baseline", 64, [],
                     {"attention_block": 12, "ffn_block": 12, "selective_scan": 1}),
    "connext": ("connext_ham", "connext", 32, [], {"fused_attention": 12, "ffn_block": 12, "kan_forward": 4}),
}


def _p50_one_row(server, request, reps: int = 10) -> float:
    """Median host-clock ms of ``server.predict`` of one-row requests (padded to its static batch)."""
    single = [{k: v[i:i + 1] for k, v in request.items()} for i in range(min(8, len(request["image"])))]
    for r in single[:3]:
        server.predict(r)
    lat = []
    for i in range(reps):
        t0 = time.perf_counter()
        server.predict(single[i % len(single)])
        lat.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(lat)


def host_ops(fn, reps: int = 3) -> dict:
    """What the host runs for one call of ``fn`` (torch.profiler, CPU records): the op
    calls a call, their summed self time, and the eight ops of most self time."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages() if e.key.startswith(("aten::", "mdhs::"))]
    top = sorted(ops, key=lambda e: -e.self_cpu_time_total)[:8]
    return {"op_calls_a_call": sum(e.count for e in ops) / reps,
            "op_self_ms_a_call": sum(e.self_cpu_time_total for e in ops) / reps / 1e3,
            "top": [{"name": e.key, "calls": e.count / reps, "self_ms": e.self_cpu_time_total / reps / 1e3}
                    for e in top]}


def _export_case(dev, rng, name: str, made: dict) -> tuple[dict, dict]:
    """Export one configuration through cli/export_serving.py, load it with
    ServingModel.load and hold it against the live ServingModel of the same
    checkpoint; (its line, the artifact's launches a forward)."""
    config, family, batch, flags, want = EXPORT_CASES[name]
    cfg, ckpt = made[config]
    path = str(EXPORT_DIR / f"{name}.pt2")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    info = export_serving.main(["--config", cfg, "--model_path", ckpt, "--family", family, "--batch_size",
                                str(batch), "--output", path, "--device", "cuda", *flags])
    export_wall_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    art = ServingModel.load(path)
    load_s = time.perf_counter() - t0
    predictor = cli_common.build_predictor(cfg, family, overrides=flags[1::2] if "--set" in flags else [],
                                           device=dev)
    predictor.load_weights(ckpt)
    live = ServingModel(predictor.model, batch, dev, image_size=predictor.image_size, tta=art.tta)
    seq, canvas = art.input_spec["input_ids"][0][1], art.input_spec["image"][0][1]
    check(canvas == CANVAS and art.batch_size == batch and art.tta == (export_serving.TTA if "--tta" in flags else ()),
          f"export {name}: artifact spec {art.input_spec}, tta {art.tta}")
    full, full2, part = _request(rng, batch, seq), _request(rng, batch, seq), _request(rng, max(1, batch // 3), seq)

    # --- launches a forward and the logits, artifact against live -------------
    launches, outs = {}, {}
    for side, server in (("artifact", art), ("live", live)):
        zero_counts()
        outs[side] = server.predict(full)
        launches[side] = read_counts()
    want = {**dict.fromkeys(KERNELS, 0), **want}
    check(launches["artifact"] == launches["live"] == want,
          f"export {name}: launches artifact {launches['artifact']}, live {launches['live']}, expected {want}")
    check(outs["artifact"].shape == (batch, 7) and bool(np.isfinite(outs["artifact"]).all()),
          f"export {name}: logits {outs['artifact'].shape}")
    for what, req in (("full", full), ("partial", part)):
        a, b = (outs["artifact"], outs["live"]) if req is full else (art.predict(req), live.predict(req))
        check(np.array_equal(a, b), f"export {name}: {what}-batch logits differ from the live model's "
              f"(max |d| {np.abs(a - b).max()})")

    # --- the device forward, host syncs, rates in turns -----------------------
    with torch.inference_mode():
        inputs = [torch.from_numpy(full[k]).to(dev) for k in ("image", "input_ids", "attention_mask")]
    fwd = {"artifact": lambda: art.fn(*inputs), "live": lambda: live.fn(*inputs)}
    device = {}
    with torch.inference_mode():
        for side in ("live", "artifact"):
            ms = cuda_ms(fwd[side], reps=5)
            prof = device_profile(fwd[side], ms, reps=2)
            device[side] = {"forward_ms": ms, "device_ms": prof["kernel_ms"], "busy_share": prof["busy_share"],
                            "launches_a_call": prof["launches_a_call"], "host": host_ops(fwd[side])}
    rates, p50 = {"live": [], "artifact": []}, {"live": [], "artifact": []}
    servers = {"live": live, "artifact": art}
    for side in ("live", "artifact", "artifact", "live"):
        rates[side].append(_stream_rate(servers[side], [full, full2], 4 if batch > 64 else 8))
        p50[side].append(_p50_one_row(servers[side], full))
    line = {"config": config, "family": family, "batch": batch, "seq": seq, "flags": flags,
            "export_s": info["seconds"], "export_cli_wall_s": export_wall_s, "load_s": load_s,
            "bytes": info["bytes"], "weight_bytes": info["weight_bytes"], "launches_a_forward": launches["artifact"],
            "logits_equal_live": True, "sync_free": sync_free_call(fwd["artifact"]), "device": device,
            "images_per_s_stream": rates, "p50_ms_one_row": p50,
            "images_per_s_median": {k: statistics.median(v) for k, v in rates.items()},
            "p50_ms_one_row_median": {k: statistics.median(v) for k, v in p50.items()}}
    if name == "mibf_tta":  # run_serve over phase_cli's PNGs, against run_predict's CSV of the same checkpoint
        csv = str(CLI_DIR / "served_tta.csv")
        zero_counts()
        ids, _ = run_serve.main(["--artifact", path, "--config", cfg, "--output_path", csv, "--family", "mibf",
                                 "--device", "cuda"])
        forwards = -(-len(ids) // batch)
        served = read_counts()
        check(served == {**dict.fromkeys(KERNELS, 0), **{k: v * forwards for k, v in EXPORT_CASES[name][4].items()}},
              f"run_serve launches {served} over {forwards} batches")
        check(Path(csv).read_bytes() == Path(made["mibf_ham_tta_csv"]).read_bytes(),
              "run_serve's CSV differs from run_predict's on the same checkpoint and images")
        line["run_serve"] = {"images": len(ids), "launches": served, "csv_equals_run_predict": True}
    del art, live, predictor, servers, fwd
    Path(path).unlink()
    gc.collect()  # the exported program's graph is cyclic: free it before the next case is timed
    torch.cuda.empty_cache()
    return line, launches["artifact"]


def python_profile(fn, calls: int = 20, top: int = 12) -> list:
    """The Python functions of most own time over ``calls`` calls of ``fn`` (cProfile; the
    profiler's own cost inflates every time): name, calls a call, own ms a call."""
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return [{"fn": f"{Path(f).name}:{line}({name})", "calls": nc / calls, "own_ms": tt / calls * 1e3}
            for (f, line, name), (_, nc, tt, _, _) in rows]


@contextlib.contextmanager
def _direct_launches():
    """Each served op's public wrapper routed past the dispatcher to its CUDA implementation,
    as the wrappers called it before the ops were registered (comparison only; the launches
    in it are counted on stand-ins and dropped)."""
    routes = {(ab, "attention_block"): ab.launch_attention_block, (fb, "ffn_block"): fb.launch_ffn_block,
              (fa, "fused_attention"): fa.launch_fused_attention, (ss, "selective_scan"): ss.launch_selective_scan,
              (ks, "kan_forward"): ks.launch_kan_forward,
              (qk, "int8_ffn_block"): lambda *a: qk.launch_int8_ffn_block(*a)[0],
              (qk, "int8_attention_block"): lambda *a: qk.launch_int8_attention_block(*a)[0]}
    saved = {key: getattr(*key) for key in routes}
    for (module, name), launch in routes.items():
        def direct(*args, _launch=launch):
            return _launch(*args)
        direct.launches, direct.launches_by_layer = 0, {}
        setattr(module, name, direct)
    try:
        yield
    finally:
        for (module, name), wrapper in saved.items():
            setattr(module, name, wrapper)


def dispatch_cost(dev, rng, seed: int) -> dict:
    """What the dispatcher adds at batch 1. Host time a call of the ffn_block and attention_block
    ops (BERT-base, seq 128) against their CUDA implementations called directly: 200 calls back
    to back (the device finishes each in under 0.03 ms, so the host bounds the loop), op and
    direct in turns. Then the live batch-1 p50 (20 one-row requests through ServingModel(batch
    1), host clock) of the exact MIBF model and of ham_fusion_ssm_v1, full width, with the
    wrappers calling the ops and calling the launches directly (_direct_launches), in turns."""
    H, Di, L = 768, 3072, 128
    ffn = (_rand(rng, (L, H), 1.0, dev), _rand(rng, (Di, H), 0.03, dev), _rand(rng, (Di,), 0.01, dev),
           _rand(rng, (H, Di), 0.03, dev), _rand(rng, (H,), 0.01, dev), _rand(rng, (H,), 0.1, dev) + 1,
           _rand(rng, (H,), 0.1, dev), 1e-12, "erf")
    attn = (_rand(rng, (1, L, H), 1.0, dev), _rand(rng, (3 * H, H), 0.03, dev), _rand(rng, (3 * H,), 0.01, dev),
            _rand(rng, (H, H), 0.03, dev), _rand(rng, (H,), 0.01, dev), _rand(rng, (H,), 0.1, dev) + 1,
            _rand(rng, (H,), 0.1, dev), _key_bias(1, L, 20, dev), 12, 0.125, 1e-12)
    calls = {"ffn_block": (torch.ops.mdhs.ffn_block.default, fb.launch_ffn_block, ffn),
             "attention_block": (torch.ops.mdhs.attention_block.default, ab.launch_attention_block, attn)}
    out = {}
    with torch.inference_mode():
        for name, (op, direct, args) in calls.items():
            us = {"op": [], "direct": []}
            for side in ("op", "direct", "direct", "op"):
                fn = op if side == "op" else direct
                for _ in range(20):
                    fn(*args)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    fn(*args)
                torch.cuda.synchronize()
                us[side].append((time.perf_counter() - t0) / 200 * 1e6)
            out[name] = {"op_us": us["op"], "direct_us": us["direct"],
                         "dispatch_us": statistics.median(us["op"]) - statistics.median(us["direct"])}
    out["per_exact_forward_ms"] = 12 * (out["ffn_block"]["dispatch_us"] + out["attention_block"]["dispatch_us"]) / 1e3
    return {**out, **p50_op_and_direct(dev, rng, seed)}


def p50_op_and_direct(dev, rng, seed: int) -> dict:
    """The live batch-1 p50 of three served models, the wrappers calling the ops and calling
    the launches directly in turns (two of each), each with a Python profile of 20 requests."""
    out = {}
    g = torch.Generator(device=dev).manual_seed(seed + 40)
    models = {"mibf_exact": lambda: MIBFNet(LABELS, BertConfig(), device=dev, dtype=torch.bfloat16),
              "ham_fusion_ssm_v1": lambda: MultimodalBaselineModel(HAM_FUSION_SSM, device=dev, dtype=torch.bfloat16),
              "ham_head_moe_v1": lambda: MultimodalBaselineModel(HAM_HEAD_MOE, device=dev, dtype=torch.bfloat16)}
    for name, make in models.items():
        server = ServingModel(init_parameters(make(), g), 1, dev)
        request = _request(rng, 8, SEQ)
        one = {k: v[:1] for k, v in request.items()}
        p50, python = {"op": [], "direct": []}, {}
        for side in ("op", "direct", "direct", "op"):
            with _direct_launches() if side == "direct" else contextlib.nullcontext():
                p50[side].append(_p50_one_row(server, request, reps=20))
                python[side] = python_profile(lambda: server.predict(one))
        out[f"p50_b1_{name}"] = {**p50, "op_over_direct": statistics.median(p50["op"]) / statistics.median(p50["direct"]),
                                 "python_profile": python}
        del server
        torch.cuda.empty_cache()
    return out


def phase_export(dev, seed: int, made: dict) -> dict:
    """The artifacts (EXPORT_CASES) exported, loaded and served beside their live models;
    returns each artifact's launches a forward."""
    rng = np.random.default_rng([seed, 40])
    EXPORT_DIR.mkdir(parents=True, exist_ok=True)
    lines, by_path = {}, {}
    try:
        for name in EXPORT_CASES:
            lines[name], by_path[f"export_{name}"] = _export_case(dev, rng, name, made)
            mark(f"export/{name}")
    finally:
        shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    emit({"phase": "export", "artifacts": lines, "dispatch_cost_b1": dispatch_cost(dev, rng, seed)})
    return by_path


# ---------------------------------------------------------------------------
# phase 17: the Spine configurations and the baseline's branches (gate, sequence encoder,
# tabular, global/local) with the dataset's stacked modes, trained, served and exported
SPINE_DIR = REPO / "mdhs_tpu_torch" / "build" / "spine_smoke"  # git-ignored; removed when the phase ends
SPINE_PATIENTS, SPINE_SLICES, SPINE_H, SPINE_W = 60, 8, 288, 320
SPINE_LABELS, SPINE_BATCH, SPINE_T, SPINE_SERVE_BATCH = 6, 64, 5, 32
SPINE_WORDS = ("lumbar", "disc", "herniation", "stenosis", "foramen", "degeneration", "L4-L5", "L5-S1", "signal",
               "bulging", "canal", "nerve", "root", "compression", "vertebral", "endplate", "modic", "sagittal",
               "T2-weighted", "facet", "hypertrophy", "mild", "moderate", "severe", "spondylolisthesis")
SPINE_MODES = ("L", "RGB", "RGBA")
# the served configurations: (config, classifier override or None, the launches a forward besides BERT's
# 12 + 12). base.yml's "kan" head is GroupKAN, which launches no kernel; the gate with the MoE head
# (ham_head_moe_v1's) puts kan_forward on a gated path: two classifier calls of two bank layers
SPINE_SERVED = (("spine_gate_entropy_v1", None, {}), ("spine_global_local_v1", None, {}),
                ("spine_multi_view_v1", None, {}), ("spine_sequence_transformer_v1", None, {}),
                ("spine_pseudo25d_v1", None, {}), ("ham_gate_entropy_v1", None, {}), ("ham_tabular_v1", None, {}),
                ("ham_gate_entropy_v1", "moe", {"kan_forward": 4}))


def _spine_slice(rng, mode: str) -> np.ndarray:
    """A seeded 288 x 320 MR-like sagittal slice: a dark field, a bright vertebral column of
    blocks, pixel noise; gray, RGB or RGBA."""
    yy, xx = np.arange(SPINE_H, dtype=np.float32)[:, None], np.arange(SPINE_W, dtype=np.float32)[None, :]
    img = np.broadcast_to(20.0 + 10.0 * np.sin(xx / rng.uniform(20, 40)), (SPINE_H, SPINE_W)).astype(np.float32)
    cx = rng.uniform(0.4, 0.6) * SPINE_W
    across = np.exp(-((xx - cx) / 40.0) ** 4)
    for k in range(5):  # each block separable: exp(-(a^4 + b^4)) = exp(-a^4) exp(-b^4)
        cy = (k + 0.5) * SPINE_H / 5 + rng.normal(0, 4)
        img += 150.0 * (np.exp(-((yy - cy) / 22.0) ** 4) * across)
    img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
    if mode == "L":
        return img
    rgb = np.stack([img, np.clip(img * 0.95, 0, 255), np.clip(img * 0.9 + 5, 0, 255)], axis=-1).astype(np.uint8)
    if mode == "RGB":
        return rgb
    return np.concatenate([rgb, rng.integers(128, 256, (SPINE_H, SPINE_W, 1), dtype=np.uint8)], axis=-1)


def _spine_inputs(seed: int) -> dict:
    """SPINE_PATIENTS patients of SPINE_SLICES numbered slices, p{k:03d}_slice_{i:03d}.png, gray, RGB
    and RGBA in turns, with gaps: every fifth patient lacks slice 6 (its neighbours fall back to the
    centre slice) and every seventh has slice 3 under the reference-intent name p{k:03d}_slice_3.png
    (found before the padded one). The records are slices 2-5 of each patient (231): 192 train,
    the next 39 val; a JSON of their descriptions, a 6-class label CSV, and a HAM-style metadata
    CSV (lesion_id,image_id,dx,dx_type,age,sex,localization) with missing ages, "unknown" and
    empty categories, and three records it does not list (their vectors zero)."""
    rng = np.random.default_rng([seed, 50])
    img_dir = SPINE_DIR / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    records, gaps = [], {"centre_fallback": 0, "reference_name": 0}
    for k in range(SPINE_PATIENTS):
        for i in range(SPINE_SLICES):
            if k % 5 == 0 and i == 6:
                gaps["centre_fallback"] += 1
                continue
            name = f"p{k:03d}_slice_{i}.png" if (k % 7 == 0 and i == 3) else f"p{k:03d}_slice_{i:03d}.png"
            gaps["reference_name"] += name.endswith("_3.png")
            png.write_png(str(img_dir / name), _spine_slice(rng, SPINE_MODES[(k + i) % 3]))
        records += [f"p{k:03d}_slice_{i:03d}.png" for i in range(2, 6) if not (k % 7 == 0 and i == 3)]
    descriptions = [{"image_info": r, "description": " ".join(rng.choice(SPINE_WORDS, int(rng.integers(10, 120))))}
                    for r in records]
    (SPINE_DIR / "descriptions.json").write_text(json.dumps(descriptions))
    labels = {r: int(rng.integers(0, SPINE_LABELS)) for r in records}
    n_train = 192
    csvs = {"train": records[:n_train], "train128": records[:128], "val": records[n_train:]}
    paths = {}
    for split, rows in csvs.items():
        paths[split] = str(SPINE_DIR / f"labels_{split}.csv")
        Path(paths[split]).write_text("image_id,label\n" + "".join(f"{r},{labels[r]}\n" for r in rows))
    sex, site = ("male", "female", "unknown", ""), ("back", "lower extremity", "trunk", "unknown", "", "scalp")
    meta = ["lesion_id,image_id,dx,dx_type,age,sex,localization"]
    for j, r in enumerate(records[:-3]):
        age = "" if j % 9 == 0 else str(int(rng.integers(20, 90)))
        meta.append(f"L{j:05d},{r[:-4]},nv,histo,{age},{sex[j % 4]},{site[j % 6]}")
    (SPINE_DIR / "metadata.csv").write_text("\n".join(meta) + "\n")
    return {"image_dir": str(img_dir), "json_path": str(SPINE_DIR / "descriptions.json"), "label_csv": paths,
            "metadata_csv": str(SPINE_DIR / "metadata.csv"), "records": records, "gaps": gaps}


def _spine_config(name: str, inputs: dict, train: str = "train", **sets) -> str:
    """mdhs_tpu_torch/configs/<name>.json on the phase's data, with ``sets`` (dotted keys), as JSON; its path."""
    cfg = load_config(REPO / "mdhs_tpu_torch" / "configs" / f"{name}.json")
    for key, val in (("data.train_image_dir", inputs["image_dir"]), ("data.train_json_path", inputs["json_path"]),
                     ("data.train_label_csv", inputs["label_csv"][train]), ("data.val_image_dir", inputs["image_dir"]),
                     ("data.val_json_path", inputs["json_path"]), ("data.val_label_csv", inputs["label_csv"]["val"]),
                     ("data.test_image_dir", inputs["image_dir"]), ("data.test_json_path", inputs["json_path"]),
                     ("data.test_label_csv", inputs["label_csv"]["val"]),
                     ("data.metadata_csv", inputs["metadata_csv"]), ("output.log_dir", str(SPINE_DIR / "runs")),
                     ("training.log_every", 1), *sets.items()):
        cfg.set(key.replace("__", "."), val)
    path = SPINE_DIR / f"{name}_{len(list(SPINE_DIR.glob('*.json')))}.json"
    cfg.save_json(path)
    return str(path)


def _rnn_routes(model, dev) -> dict:
    """The trained LSTM at its full-width shape, (64, 5, 256) -> 2 x 256: the port's loop (flax's
    rounding order) and cuDNN's nn.LSTM on the same weights (its input biases zero), each in bf16
    against the loop in float32; max and mean |d| and CUDA-event ms of each."""
    rnn = model.sequence_encoder.rnn
    x = torch.randn((SPINE_BATCH, SPINE_T, rnn.hidden_size), generator=torch.Generator(device=dev).manual_seed(5),
                    device=dev)
    ref_rnn = copy.deepcopy(rnn).float()
    lstm = nn.LSTM(rnn.hidden_size, rnn.hidden_size, batch_first=True, bidirectional=True, device=dev,
                   dtype=torch.bfloat16)
    with torch.no_grad():
        for name, p in lstm.named_parameters():
            p.copy_(getattr(rnn, name) if hasattr(rnn, name) else torch.zeros_like(p))
    out = {}
    with torch.inference_mode():
        ref = ref_rnn(x)
        bf = x.to(torch.bfloat16)
        for route, fn in (("loop_bf16", lambda: rnn(bf)), ("cudnn_lstm_bf16", lambda: lstm(bf)[0])):
            y = fn().float()
            out[route] = {"max_abs_vs_float32_loop": (y - ref).abs().max().item(),
                          "mean_abs_vs_float32_loop": (y - ref).abs().mean().item(), "ms": cuda_ms(fn)}
        out["loop_float32_ms"] = cuda_ms(lambda: ref_rnn(x))
    return out


def _spine_train(dev, inputs: dict, seed: int) -> tuple[dict, dict]:
    """run_train on spine_sequence_lstm_v1.json at full width (batch 64 x 5 slices, 320 images a
    step through ResNet18, BERT-base at seq 128, the LSTM, multiscale fusion, MLP head): one epoch
    of 3 steps and a validation pass; then, on the trainer it returns, the augmentation of the
    (64, 5) stack through shear_sublane against the plain shear bit for bit, a step against the same
    step on the plain shear, step parts, rates, the device, and the LSTM's two routes."""
    layers = BertConfig().num_hidden_layers
    cfg = _spine_config("spine_sequence_lstm_v1", inputs, training__num_epochs=1)
    zero_counts()
    t0 = time.perf_counter()
    trainer = run_train.main(["--config", cfg, "--device", "cuda"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_counts()
    want = {**dict.fromkeys(KERNELS, 0), "shear_sublane": 3 * 3, "attention_block": layers, "ffn_block": layers}
    check(launches == want and trainer.step == 3, f"spine train launches {launches}, expected {want}")
    files = _run_files(trainer.output_dir)
    losses = [r["value"] for r in map(json.loads, Path(trainer.output_dir, "metrics.jsonl").read_text().splitlines())
              if r["tag"] == "Loss/Train_Batch"]
    check(len(losses) == 3 and all(np.isfinite(losses)), f"spine train losses {losses}")
    batches = list(trainer.train_loader)
    b0 = batches[0]
    check(b0["image"].shape == (SPINE_BATCH, SPINE_T, CANVAS, CANVAS, 3), f"spine batch {b0['image'].shape}")
    # the (64, 5) stack's augmentation, one draw over its 320 images: the kernel against the plain shear
    dev_b = trainer.to_device(b0)
    valid = trainer.valid_mask(b0, SPINE_BATCH)
    n_img = SPINE_BATCH * SPINE_T
    p = aug.sample_crop_flip_rotate(n_img, CANVAS, trainer.generator, vflip=True, degrees=45.0)
    j = aug.sample_color_jitter(n_img, trainer.generator)
    with torch.no_grad():
        zero_counts()
        x_kernel = trainer.augment(dev_b["image"], params=p, jitter=j)
        aug_launches = read_counts()["shear_sublane"]
        with _plain_op(aug, "shear_sublane", sh.shear_reference):
            x_plain = trainer.augment(dev_b["image"], params=p, jitter=j)
    aug_d = diff(x_kernel, x_plain)
    check(aug_d[0] == 0.0 and aug_launches == 3 and x_kernel.shape == (SPINE_BATCH, SPINE_T, 3, 224, 224),
          f"spine augmentation kernel vs plain: {aug_d}, {aug_launches} shears, {tuple(x_kernel.shape)}")
    groups = {"sequence_encoder": list(trainer.model.sequence_encoder.parameters()),
              "text_encoder": list(trainer.model.text_encoder.parameters())}
    step = {}
    for which, x in (("kernel", x_kernel), ("plain", x_plain)):
        torch.manual_seed(seed)
        loss, _ = trainer.forward_backward(x, dev_b, valid)
        step[which] = (loss.item(), {k: torch.cat([q.grad.double().flatten() for q in ps]) for k, ps in groups.items()})
    (loss_k, gk), (loss_p, gp) = step["kernel"], step["plain"]
    rel = abs(loss_k - loss_p) / abs(loss_p)
    cos = {k: (gk[k] @ gp[k] / (gk[k].norm() * gp[k].norm() + 1e-30)).item() for k in groups}
    check(rel <= BASELINE_TRAIN_LOSS_REL and all(c >= BASELINE_TRAIN_GRAD_COS for c in cos.values()),
          f"spine step vs plain shear: loss {loss_k} vs {loss_p}, gradient cosines {cos}")
    trainer.model.zero_grad(set_to_none=True)
    parts = _step_parts_ms(trainer, b0, reps=3)
    records_per_s = _images_per_s(trainer, batches, steps=4)
    device = device_profile(lambda: trainer.train_step(b0), parts["step_ms"], reps=2, top=10)
    line = {"config": "spine_sequence_lstm_v1", "records": len(trainer.train_loader.dataset), "run_s": run_s,
            "launches_run": launches, "losses": losses, "run_files": files["tags"],
            "augment_kernel_vs_plain_max_abs": aug_d[0], "shear_batch": n_img,
            "step_vs_plain_shear": {"loss_kernel": loss_k, "loss_plain": loss_p, "loss_rel": rel, "grad_cosine": cos},
            "step_parts_ms": parts, "event_ms_per_step": parts["step_ms"], "device_ms_per_step": device["kernel_ms"],
            "busy_share": device["busy_share"], "records_per_s": records_per_s, "slices_per_s": records_per_s * SPINE_T,
            "device": device, "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "lstm_routes": _rnn_routes(trainer.model, dev)}
    del trainer, batches, x_kernel, x_plain
    torch.cuda.empty_cache()
    return line, {"spine_train": launches}


def _spine_request(cfg_path: str, n: int) -> tuple[dict, int]:
    """The first ``n`` test records of a configuration through its own dataset and loader (its
    stacked mode, its tabular vectors): a serving request, and the tabular width."""
    cfg = load_config(cfg_path)
    tok = load_tokenizer_for(cfg)
    ds = cli_data.MultimodalDataset(cfg.get("data.test_image_dir"), cfg.get("data.test_json_path"),
                                    cfg.get("data.test_label_csv"), tok,
                                    cli_data.DatasetOptions.from_config(cfg, "baseline", "test"))
    batch = next(iter(DataLoader(ds, batch_size=n)))
    keys = ("image", "input_ids", "attention_mask") + (("tabular",) if "tabular" in batch else ())
    return {k: np.asarray(batch[k]) for k in keys}, ds.tabular_dim


def load_tokenizer_for(cfg):
    return load_tokenizer(cfg.get("model.text_encoder.model_name"),
                          vocab_size=cfg.get("model.text_encoder.vocab_size", 30522))


def _spine_serve(dev, inputs: dict, seed: int) -> tuple[dict, dict]:
    """Each SPINE_SERVED configuration at full width (ResNet18, BERT-base at seq 128, hidden 256,
    bf16, seeded weights) through ServingModel at batch 32 on its own dataset's first 32 test
    records: launches, the logits against the same weights with BERT's kernels (with the MoE head,
    kan_forward) routed to their plain versions, CUDA-event and device ms a forward, sync_free."""
    layers = BertConfig().num_hidden_layers
    lines, by_path = {}, {}
    for i, (name, head, extra) in enumerate(SPINE_SERVED):
        sets = {"model__classifier_type": head} if head else {}
        cfg_path = _spine_config(name, inputs, **sets)
        cfg = load_config(cfg_path)
        req, width = _spine_request(cfg_path, SPINE_SERVE_BATCH)
        g = torch.Generator(device=dev).manual_seed(seed + 60 + i)
        model = init_parameters(build_model(cfg, "baseline", load_tokenizer_for(cfg), device=dev,
                                            dtype=torch.bfloat16, tabular_dim=width), g).eval()
        if head == "moe":
            _route_rows_apart(model, req, dev, g)
        server = ServingModel(model, SPINE_SERVE_BATCH, dev)
        zero_counts()
        out = server.predict(req)
        launches = read_counts()
        want = {**dict.fromkeys(KERNELS, 0), "attention_block": layers, "ffn_block": layers, **extra}
        check(launches == want, f"{name} launches {launches}, expected {want}")
        check(out.shape == (SPINE_SERVE_BATCH, cfg.get("model.num_classes")) and bool(np.isfinite(out).all()),
              f"{name} logits {out.shape}")
        # with the MoE head, kan_forward alone on its plain version, BERT's kernels in place, as phase
        # baseline holds it: the gate reads the same features on both paths, so the rows route alike and
        # the float32 kernel's ~1e-6 difference flips a bf16 rounding now and then (BF16_STEPS, BF16_MEAN).
        # Otherwise BERT's two sublayers on their plain versions: bf16 kernels against bf16 ops move every
        # row's CLS (phase slice), so the logits move together: max |d| within BF16_STEPS of the largest
        # logit, mean |d| within CONNEXT_LOGIT_MEAN of it (ConNexT's bound for logits that differ in BERT)
        # and under SLICE_MEAN (the MIBF model bound).
        if head == "moe":
            plain_ops, mean_frac = [(ks, "kan_forward", ks.kan_forward_reference)], BF16_MEAN
        else:
            plain_ops = [(ab, "attention_block", ab.attention_block_reference),
                         (fb, "ffn_block", fb.ffn_block_reference)]
            mean_frac = CONNEXT_LOGIT_MEAN
        with contextlib.ExitStack() as stack:
            for module, op, plain in plain_ops:
                stack.enter_context(_plain_op(module, op, plain))
            zero_counts()
            ref = server.predict(req)
            plain_counts = read_counts()
        routed = [op for _, op, _ in plain_ops]
        check(all(plain_counts[op] == 0 for op in routed) and
              all(plain_counts[k] == launches[k] for k in KERNELS if k not in routed),
              f"{name}: launches {plain_counts} with {routed} on their plain versions")
        lmax, lmean = diff(torch.from_numpy(out), torch.from_numpy(ref))
        scale = float(np.abs(ref).max())
        bound = BF16_STEPS * scale
        mean_bound = min(SLICE_MEAN, mean_frac * scale)
        check(lmax <= bound and lmean <= mean_bound,
              f"{name} logits kernels vs plain {routed}: max {lmax} (bound {bound}) mean {lmean} "
              f"(bound {mean_bound}), max |logit| {scale}")
        dev_in = [torch.from_numpy(req[k]).to(dev, dt) for k, dt in server.inputs.items()]
        with torch.inference_mode():
            fwd = lambda: server.fn(*dev_in)  # noqa: E731
            forward_ms = cuda_ms(fwd, reps=10)
            device = device_profile(fwd, forward_ms, top=6)
        key = f"{name}+{head}" if head else name
        lines[key] = {"image": list(req["image"].shape), "tabular_width": width, "launches": launches,
                      "logits_vs_plain": {"plain": routed, "max_abs": lmax, "mean_abs": lmean, "max_abs_logit": scale,
                                          "max_abs_over_max_logit": lmax / scale, "max_abs_bound": bound,
                                          "mean_abs_bound": mean_bound},
                      "sync_free": sync_free_call(fwd), "forward_ms_b32": forward_ms,
                      "device_ms_b32": device["kernel_ms"], "device": device}
        by_path[f"spine_serve_{key}"] = launches
        del model, server
        torch.cuda.empty_cache()
    return lines, by_path


def _spine_export(dev, inputs: dict) -> tuple[dict, dict]:
    """ham_tabular_v1 trained 2 steps by run_train (128 records, batch 64), exported with its tabular
    input by cli/export_serving.py at the configuration's batch, 64 (run_predict's), loaded by
    ServingModel.load and held against the live ServingModel of the same checkpoint on a full request:
    launches, logits bit for bit, a moved record moves them, device ms; run_serve's CSV against
    run_predict's."""
    layers = BertConfig().num_hidden_layers
    cfg = _spine_config("ham_tabular_v1", inputs, train="train128", training__num_epochs=1)
    zero_counts()
    trainer = run_train.main(["--config", cfg, "--device", "cuda"])
    torch.cuda.synchronize()
    train_launches = read_counts()
    want = {**dict.fromkeys(KERNELS, 0), "shear_sublane": 6, "attention_block": layers, "ffn_block": layers}
    check(train_launches == want and trainer.step == 2, f"ham_tabular train launches {train_launches}")
    best = str(Path(trainer.output_dir, _run_files(trainer.output_dir)["checkpoints"][0]["path"]))
    width = trainer.model.cfg.tabular_input_dim
    del trainer
    torch.cuda.empty_cache()
    art = str(SPINE_DIR / "ham_tabular.pt2")
    t0 = time.perf_counter()
    info = export_serving.main(["--config", cfg, "--model_path", best, "--output", art, "--batch_size",
                                str(SPINE_BATCH), "--device", "cuda"])
    export_s = time.perf_counter() - t0
    check(info["inputs"]["tabular"] == [[SPINE_BATCH, width], "float32"], f"artifact inputs {info['inputs']}")
    loaded = ServingModel.load(art, dev)
    predictor = cli_common.build_predictor(cfg, device=dev)
    predictor.load_weights(best)
    live = predictor.server()
    req, _ = _spine_request(cfg, SPINE_BATCH)
    out = {}
    for which, server in (("live", live), ("artifact", loaded)):
        zero_counts()
        out[which] = server.predict(req)
        out[f"{which}_launches"] = read_counts()
    check(out["live_launches"] == out["artifact_launches"] == {**dict.fromkeys(KERNELS, 0), "attention_block": layers,
                                                                "ffn_block": layers},
          f"ham_tabular artifact launches {out['artifact_launches']}, live {out['live_launches']}")
    check(np.array_equal(out["live"], out["artifact"]), "ham_tabular: the artifact's logits are not the live model's")
    moved = dict(req, tabular=req["tabular"] + 1.0)
    check(not np.array_equal(loaded.predict(moved), out["artifact"]), "ham_tabular: the record does not reach the logits")
    dev_in = [torch.from_numpy(req[k]).to(dev, dt) for k, dt in loaded.inputs.items()]
    with torch.inference_mode():
        fwd = lambda: loaded.fn(*dev_in)  # noqa: E731
        ms = cuda_ms(fwd, reps=10)
        device = device_profile(fwd, ms)
    serve_csv, pred_csv = str(SPINE_DIR / "serve.csv"), str(SPINE_DIR / "predict.csv")
    run_serve.main(["--artifact", art, "--config", cfg, "--output_path", serve_csv, "--device", "cuda"])
    run_predict.main(["--config", cfg, "--model_path", best, "--output_path", pred_csv, "--device", "cuda"])
    check(Path(serve_csv).read_text() == Path(pred_csv).read_text(), "ham_tabular: run_serve's CSV is not run_predict's")
    line = {"config": "ham_tabular_v1", "train_launches": train_launches, "tabular_width": width,
            "export_s": export_s, "bytes": info["bytes"], "launches": out["artifact_launches"],
            "logits_bit_equal": True, "forward_ms_b64": ms, "device_ms_b64": device["kernel_ms"], "device": device,
            "sync_free": sync_free_call(fwd), "run_serve_csv_equals_run_predict": True}
    return line, {"spine_export_train": train_launches, "spine_export_artifact": out["artifact_launches"]}


def phase_spine(dev, seed: int) -> dict:
    """The Spine configurations and the baseline's branches on the card (SPINE_DIR, removed after),
    a line for each part; returns each path's launches."""
    shutil.rmtree(SPINE_DIR, ignore_errors=True)
    SPINE_DIR.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        inputs = _spine_inputs(seed)
        emit({"phase": "spine", "part": "data", "records": len(inputs["records"]), "gaps": inputs["gaps"],
              "seconds": time.perf_counter() - t0})
        torch.cuda.reset_peak_memory_stats(dev)
        train, by_path = _spine_train(dev, inputs, seed)
        emit({"phase": "spine", "part": "train", **train})
        serve, serve_paths = _spine_serve(dev, inputs, seed)
        emit({"phase": "spine", "part": "serve", "configs": serve})
        export, export_paths = _spine_export(dev, inputs)
        emit({"phase": "spine", "part": "export", **export})
    finally:
        shutil.rmtree(SPINE_DIR, ignore_errors=True)
    return {**by_path, **serve_paths, **export_paths}


FUSION_DIR = REPO / "mdhs_tpu_torch" / "build" / "fusion_smoke"  # git-ignored; removed when the phase ends
MAMBA_DIR = REPO / "mdhs_tpu_torch" / "build" / "mamba_smoke"  # the same for phase mamba
# the configurations that name the baseline fusions other than multiscale and mamba, served live at batch 64, seq 128
FUSION_SERVED = ("ham_fusion_crossattn_v1", "ham_tta_attention_basic_mlp_v1", "ham_fusion_weighted_v1",
                 "ham_fusion_hadamard_v1", "ham_fusion_bilinear_v1", "ham_fusion_vmamba_v1", "spine_hierarchical_v1")
# the records of phases fusion and mamba: FUSION_PNGS seeded 600 x 450 images, each under several names;
# 192 train records (3 steps at batch 64; the first 128, 2 steps; the first 64, 2 steps at batch 32),
# 64 val / test records (one batch; the first 32, one batch at 32)
FUSION_PNGS, FUSION_TRAIN, FUSION_VAL = 64, 3 * BASELINE_BATCH, BASELINE_BATCH
PHASE_SPLITS = {"train": slice(0, FUSION_TRAIN), "train2": slice(0, 2 * BASELINE_BATCH),
                "val": slice(FUSION_TRAIN, None), "train_cx": slice(0, 2 * CONNEXT_BATCH),
                "val_cx": slice(FUSION_TRAIN, FUSION_TRAIN + CONNEXT_BATCH)}
MAMBA_VISION = "ham_mamba_vision_v1"  # MambaVision-T at 224, BERT-base at seq 128, basic fusion, mlp head
MV_SCANS = 6  # selective_scan a MambaVision-T forward: stage 3's mixers 0-3, stage 4's mixers 0-1
LLM_HIDDEN = 3584  # the LLM hidden-state width (connext_ham's data.llm_hidden_dim)
# ConNexT with the multimodal Mamba fusion: connext_ham.json and these overrides
FUSION_SETS = {"model.mamba_fusion.enabled": True, "data.llm_hidden_dim": LLM_HIDDEN}
FUSION_KAN = 3  # kan_forward a fusion forward: the KAN attention's q, k and v


def _phase_inputs(root: Path, rng, classes=(LABELS,), hidden=()) -> dict:
    """FUSION_TRAIN + FUSION_VAL records over FUSION_PNGS images drawn from ``rng`` in ``root``, a JSON
    of their descriptions (8-300 words: most past seq 128), a label CSV of each PHASE_SPLITS split for
    each class count, and where ``hidden`` names splits, a hidden-state JSON (LLM_HIDDEN-wide first and
    last vectors, rounded to 4 decimals) of their records, the first (``left_out``) left out."""
    img_dir = root / "images"
    img_dir.mkdir(parents=True)
    names = [f"ISIC_{i:07d}.png" for i in range(FUSION_TRAIN + FUSION_VAL)]
    for i, name in enumerate(names):
        if i < FUSION_PNGS:
            png.write_png(str(img_dir / name), _cli_image(rng))
        else:
            shutil.copyfile(img_dir / names[i % FUSION_PNGS], img_dir / name)
    (root / "descriptions.json").write_text(json.dumps(
        [{"image_info": n, "description": " ".join(rng.choice(CLI_WORDS, int(rng.integers(8, 300))))} for n in names]))
    labels = rng.integers(0, LABELS, len(names))
    inputs = {"root": root, "image_dir": str(img_dir), "json_path": str(root / "descriptions.json"), "label_csv": {}}
    for n_classes in classes:
        for split, rows in PHASE_SPLITS.items():
            path = root / f"labels_{split}_{n_classes}.csv"
            path.write_text("image_id,label\n" + "".join(f"{n},{c % n_classes}\n"
                                                          for n, c in zip(names[rows], labels[rows])))
            inputs["label_csv"][split, n_classes] = str(path)
    if hidden:
        rows = [n for split in hidden for n in names[PHASE_SPLITS[split]]]
        (root / "hidden.json").write_text(json.dumps(
            {f"llm_out/{n}": {k: np.round(rng.standard_normal(LLM_HIDDEN), 4).tolist()
                              for k in ("first_hidden_state", "last_hidden_state")} for n in rows[1:]}))
        inputs.update(hidden_json=str(root / "hidden.json"), left_out=rows[0])
    return inputs


def _phase_config(name: str, inputs: dict, train: str = "train", val: str = "val", tag: str | None = None,
                  **sets) -> str:
    """mdhs_tpu_torch/configs/<name>.json on a phase's records (the ``train`` and ``val`` label CSVs of
    its class count; the test split ``val``'s), with ``sets`` (dotted keys, ``__`` for a dot), as JSON
    under ``tag`` (the name by default); its path."""
    root = inputs["root"]
    cfg = load_config(REPO / "mdhs_tpu_torch" / "configs" / f"{name}.json")
    csv = lambda split: inputs["label_csv"][split, cfg.get("model.num_classes")]  # noqa: E731
    for key, value in (("data.train_image_dir", inputs["image_dir"]), ("data.train_json_path", inputs["json_path"]),
                       ("data.train_label_csv", csv(train)), ("data.val_image_dir", inputs["image_dir"]),
                       ("data.val_json_path", inputs["json_path"]), ("data.val_label_csv", csv(val)),
                       ("data.test_image_dir", inputs["image_dir"]), ("data.test_json_path", inputs["json_path"]),
                       ("data.test_label_csv", csv(val)), ("output.log_dir", str(root / "runs")),
                       ("training.log_every", 1), ("training.num_epochs", 1), *sets.items()):
        cfg.set(key.replace("__", "."), value)
    path = root / f"{tag or name}.json"
    cfg.save_json(path)
    return str(path)


def _vs_plain(server, req: dict, out: np.ndarray, launches: dict, routes: list, max_frac: float, mean_frac: float,
              what: str, mean_cap: float = float("inf")) -> dict:
    """The served logits against the same weights with ``routes`` [(module, op, plain)] on their plain
    versions (every other kernel's launches unchanged): max |d| <= max_frac of the largest logit and
    mean |d| <= the least of mean_frac of it and mean_cap."""
    with contextlib.ExitStack() as stack:
        for module, op, plain in routes:
            stack.enter_context(_plain_op(module, op, plain))
        zero_counts()
        ref = server.predict(req)
        plain_counts = read_counts()
    routed = [op for _, op, _ in routes]
    check(all(plain_counts[op] == 0 for op in routed) and
          all(plain_counts[k] == launches[k] for k in KERNELS if k not in routed),
          f"{what}: launches {plain_counts} with {routed} on their plain versions")
    lmax, lmean = diff(torch.from_numpy(out), torch.from_numpy(ref))
    scale = float(np.abs(ref).max())
    bound, mean_bound = max_frac * scale, min(mean_cap, mean_frac * scale)
    check(lmax <= bound and lmean <= mean_bound, f"{what} logits kernels vs plain {routed}: max {lmax} (bound {bound})"
                                                 f" mean {lmean} (bound {mean_bound}), max |logit| {scale}")
    return {"plain": routed, "max_abs": lmax, "mean_abs": lmean, "max_abs_logit": scale,
            "max_abs_over_max_logit": lmax / scale, "max_abs_bound": bound, "mean_abs_bound": mean_bound}


BERT_PLAIN_128 = [(ab, "attention_block", ab.attention_block_reference), (fb, "ffn_block", fb.ffn_block_reference)]
BERT_PLAIN_512 = [(fa, "fused_attention", fa.attention_reference), (fb, "ffn_block", fb.ffn_block_reference)]
SCAN_PLAIN = [(ss, "selective_scan", ss.selective_scan_reference)]
FUSION_PLAIN = SCAN_PLAIN + [(ks, "kan_forward", ks.kan_forward_reference)]
# the logits' bounds against each route on plain (max and mean fractions of the largest logit, mean cap):
# BERT's sublayers move every row's CLS (BF16_STEPS, and the mean within CONNEXT_LOGIT_MEAN of the
# largest logit and under SLICE_MEAN); the scan alone is a float32 kernel ~1e-6 from its plain version,
# a bf16 rounding flipped now and then downstream (BF16_STEPS, BF16_MEAN)
BERT_128_BOUNDS = (BERT_PLAIN_128, BF16_STEPS, CONNEXT_LOGIT_MEAN, SLICE_MEAN)
SCAN_BOUNDS = (SCAN_PLAIN, BF16_STEPS, BF16_MEAN, SLICE_MEAN)


def _served_line(server, req: dict, out: np.ndarray, launches: dict, **extra) -> dict:
    """CUDA-event and device ms of a served forward (live or loaded) from device-resident inputs, the
    busy share, sync_free, beside the launches, the logits' shape and ``extra``."""
    dev_in = {k: torch.from_numpy(req[k]).to(server.device, dt) for k, dt in server.inputs.items()}
    with torch.inference_mode():
        if server.model is None:  # a loaded artifact takes its inputs by position
            fwd = lambda: server.fn(*dev_in.values())  # noqa: E731
        else:
            fwd = lambda: server.fn(**dev_in)  # noqa: E731
        forward_ms = cuda_ms(fwd, reps=10)
        device = device_profile(fwd, forward_ms, top=6)
    return {"launches": launches, "logits": list(out.shape), **extra, "sync_free": sync_free_call(fwd),
            "forward_ms": forward_ms, "device_ms": device["kernel_ms"], "busy_share": device["busy_share"],
            "device": device}


def _serve_baseline(dev, name: str, g_seed: int, rng, scans: int, plain: dict) -> tuple[dict, dict]:
    """mdhs_tpu_torch/configs/<name>.json at full width (bf16, weights seeded by ``g_seed``, the request
    drawn from ``rng``) through ServingModel at batch 64, seq 128 with its TTA: 12 + 12 launches of
    BERT's two sublayers and ``scans`` selective_scan, finite logits, each of ``plain`` (label: (routes,
    max_frac, mean_frac, mean_cap)) against the same weights with those routes on plain, and
    _served_line's times; the line and the launches."""
    layers = BertConfig().num_hidden_layers
    cfg = load_config(REPO / "mdhs_tpu_torch" / "configs" / f"{name}.json")
    model = init_parameters(build_model(cfg, "baseline", load_tokenizer_for(cfg), device=dev, dtype=torch.bfloat16),
                            torch.Generator(device=dev).manual_seed(g_seed)).eval()
    tta = cli_common.tta_transforms(cfg.get("inference.tta"))
    req = _request(rng, BASELINE_BATCH, BASELINE_SEQ)
    server = ServingModel(model, BASELINE_BATCH, dev, tta=tta)
    zero_counts()
    out = server.predict(req)
    launches = read_counts()
    want = {**dict.fromkeys(KERNELS, 0), "attention_block": layers, "ffn_block": layers, "selective_scan": scans}
    check(launches == want and out.shape == (BASELINE_BATCH, cfg.get("model.num_classes"))
          and bool(np.isfinite(out).all()), f"{name} launches {launches}, expected {want}; logits {out.shape}")
    vs_plain = {label: _vs_plain(server, req, out, launches, routes, max_frac, mean_frac, name, mean_cap=cap)
                for label, (routes, max_frac, mean_frac, cap) in plain.items()}
    line = {"tower": [model.cfg.image_backbone, model.image_encoder.proj4.in_features],
            "fusion": cfg.get("model.fusion_type"), "tta": list(tta),
            **_served_line(server, req, out, launches, logits_vs_plain=vs_plain)}
    del model, server
    torch.cuda.empty_cache()
    return line, launches


def _fusion_run(name: str, cfg: str, steps: int, scans_a_forward: int, family: str = "baseline",
                kan_a_forward: int = 0) -> tuple:
    """run_train of ``cfg`` (one epoch of ``steps`` steps and a validation batch) with every count at 0
    just before it: (the trainer, its launches, host-clock seconds, the run's files, its best checkpoint).
    A step launches 3 shears and the scan and kan_forward as a forward does; validation BERT's kernels
    (a connext run's BERT at seq 512: fused_attention and ffn_block) too."""
    layers = BertConfig().num_hidden_layers
    attention = "fused_attention" if family == "connext" else "attention_block"
    zero_counts()
    t0 = time.perf_counter()
    trainer = run_train.main(["--config", cfg, "--family", family, "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    want = {**dict.fromkeys(KERNELS, 0), "shear_sublane": 3 * steps, attention: layers, "ffn_block": layers,
            "selective_scan": scans_a_forward * (steps + 1), "kan_forward": kan_a_forward * (steps + 1)}
    check(launches == want and trainer.step == steps, f"{name} run: step {trainer.step}, launches {launches}, "
                                                      f"expected {want}")
    files = _run_files(trainer.output_dir)
    return trainer, launches, seconds, files, str(Path(trainer.output_dir, files["checkpoints"][0]["path"]))


def _step_line(name: str, trainer, batch, groups: dict, seed: int, want: dict, more=(), reps: int = 2) -> dict:
    """One step of ``trainer`` on ``batch`` against the same step with selective_scan (and each of
    ``more``) on its plain version (_kernel_vs_plain_step: ``groups``' gradient cosines), the launches
    of one step (3 shears and ``want``), the step's parts' ms."""
    vs_plain = _kernel_vs_plain_step(trainer, batch, ss, "selective_scan", ss.selective_scan_reference, groups, seed,
                                     more=more)
    trainer.model.zero_grad(set_to_none=True)
    zero_counts()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    launches = read_counts()
    check(launches == {**dict.fromkeys(KERNELS, 0), "shear_sublane": 3, **want}, f"{name} step launches {launches}")
    return {"launches_step": launches, "step_vs_plain": vs_plain,
            "step_parts_ms": _step_parts_ms(trainer, batch, reps=reps)}


def _predict_line(dev, name: str, cfg: str, ckpt: str, family: str, want: dict, rows: int) -> tuple:
    """run_predict of ``cfg`` (its TTA CLI_TTA) over ``ckpt`` with every count at 0 just before it:
    launches ``want``, ``rows`` logits and CSV rows, bit for bit the live TTA server's on the test
    loader's first batch. Returns the line, the predictor, that batch and the live logits."""
    out_csv = Path(cfg).with_suffix(".csv")
    zero_counts()
    t0 = time.perf_counter()
    pred = run_predict.main(["--config", cfg, "--model_path", ckpt, "--output_path", str(out_csv),
                             "--family", family, "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    check(launches == {**dict.fromkeys(KERNELS, 0), **want}, f"{name} run_predict launches {launches}")
    predictor = cli_common.build_predictor(cfg, family=family, device=dev)
    predictor.load_weights(ckpt)
    tta = cli_common.tta_transforms(predictor.cfg.get("inference.tta"))
    check(tta == CLI_TTA, f"{name}: TTA {tta}")
    b = next(iter(predictor.make_test_loader()))
    live = predictor.server(tta).predict(b)[: int(b["n_valid"])]
    check(pred["logits"].shape == (rows, LABELS) and len(out_csv.read_text().splitlines()) == rows + 1
          and np.array_equal(pred["logits"], live), f"{name}: run_predict's logits against the live TTA server")
    line = {"tta": list(tta), "seconds": seconds, "images_per_s": rows / seconds, "launches": launches,
            "logits_equal_live_tta_server": True}
    return line, predictor, b, live


def _export_cases(dev, phase: str, cases: list, best: dict, rng_key: int, seed: int) -> tuple[dict, dict]:
    """Each case (name, config path, family, batch, seq, launches a forward) exported from its trained
    best checkpoint by cli/export_serving.py at its batch, loaded by ServingModel.load and held against
    the live ServingModel of the same checkpoint given no hidden vectors (an artifact takes none and
    the fusion reads zeros, as JAX's): the launches on both, logits bit for bit, _served_line's times."""
    lines, by_path = {}, {}
    for i, (name, cfg, family, batch, seq, want) in enumerate(cases):
        art = str(Path(cfg).with_suffix(".pt2"))
        t0 = time.perf_counter()
        info = export_serving.main(["--config", cfg, "--model_path", best[name], "--output", art, "--batch_size",
                                    str(batch), "--family", family, "--device", "cuda"])
        export_s = time.perf_counter() - t0
        loaded = ServingModel.load(art, dev)
        predictor = cli_common.build_predictor(cfg, family=family, device=dev)
        predictor.load_weights(best[name])
        live = predictor.server()
        check(not predictor.hidden and list(loaded.inputs) == list(live.inputs)
              and list(loaded.inputs)[:3] == ["image", "input_ids", "attention_mask"],
              f"{name} artifact inputs {list(loaded.inputs)}, live {list(live.inputs)}")
        req = _request(np.random.default_rng([seed, rng_key, i]), batch, seq)
        out = {}
        for which, server in (("live", live), ("artifact", loaded)):
            zero_counts()
            out[which] = server.predict(req)
            out[f"{which}_launches"] = read_counts()
        want = {**dict.fromkeys(KERNELS, 0), **want}
        check(out["live_launches"] == out["artifact_launches"] == want,
              f"{name} artifact launches {out['artifact_launches']}, live {out['live_launches']}, expected {want}")
        check(np.array_equal(out["live"], out["artifact"]), f"{name}: the artifact's logits are not the live model's")
        lines[name] = {"export_s": export_s, "bytes": info["bytes"], "batch": batch,
                       **_served_line(loaded, req, out["artifact"], out["artifact_launches"], logits_bit_equal=True)}
        by_path[f"{phase}_export_{name}"] = out["artifact_launches"]
        del loaded, predictor, live
        torch.cuda.empty_cache()
        mark(f"{phase}/export/{name}")
    return lines, by_path


def _phase(phase: str, root: Path, dev, seed: int, rng_key: int, make_inputs, serve, train, export_cases) -> dict:
    """A phase of served, trained and exported configurations on the card in ``root`` (removed after):
    ``make_inputs()`` its records, ``serve()`` (lines, launches by path), ``train(inputs)`` (lines,
    launches by path, best checkpoints), _export_cases of ``export_cases(inputs)`` (requests drawn
    from [seed, rng_key, i]); a line for each part; returns each path's launches."""
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t_phase = time.perf_counter()
    try:
        inputs = make_inputs()
        mark(f"{phase}/inputs")
        serve_lines, by_path = serve()
        emit({"phase": phase, "part": "serve", "configs": serve_lines})
        torch.cuda.reset_peak_memory_stats(dev)
        train_lines, train_paths, best = train(inputs)
        emit({"phase": phase, "part": "train", "runs": train_lines})
        export_lines, export_paths = _export_cases(dev, phase, export_cases(inputs), best, rng_key, seed)
        emit({"phase": phase, "part": "export", "artifacts": export_lines,
              "phase_seconds": time.perf_counter() - t_phase})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {**by_path, **train_paths, **export_paths}


def _fusion_serve(dev, seed: int) -> tuple[dict, dict]:
    """Each FUSION_SERVED configuration (ResNet18, BERT-base at seq 128, hidden 256) through
    _serve_baseline (ham_tta_attention_basic_mlp_v1 with its TTA, one fused forward of 256 rows): the
    logits against BERT's two sublayers on plain (vmamba: selective_scan alone, BERT's kernels kept)."""
    lines, by_path = {}, {}
    for i, name in enumerate(FUSION_SERVED):
        vmamba = name == "ham_fusion_vmamba_v1"
        lines[name], by_path[f"fusion_serve_{name}"] = _serve_baseline(
            dev, name, seed + 80 + i, np.random.default_rng([seed, 80, i]), 2 if vmamba else 0,
            {"scan": SCAN_BOUNDS} if vmamba else {"bert": BERT_128_BOUNDS})
    return lines, by_path


def _fusion_train(dev, inputs: dict, seed: int) -> tuple[dict, dict, dict]:
    """run_train of ham_fusion_vmamba_v1 (3 steps at batch 64: the two scans under autograd, their
    backward the associative scan's VJP) with _step_line against the plain scan and the step's device
    ms; of ham_fusion_crossattn_v1 and spine_hierarchical_v1 (2 steps each); then run_predict of
    ham_tta_attention_basic_mlp_v1 with its TTA over the crossattn run's best checkpoint (_predict_line).
    Returns the lines, the launches of each path and the best checkpoints by configuration."""
    lines, by_path, best = {}, {}, {}
    name = "ham_fusion_vmamba_v1"
    trainer, launches, seconds, files, best[name] = _fusion_run(name, _phase_config(name, inputs), 3, 2)
    batch = next(iter(trainer.train_loader))
    groups = {"fusion.vmamba": [p for n, p in trainer.model.named_parameters() if n.startswith("fusion.vmamba.")],
              "text_encoder": list(trainer.model.text_encoder.parameters())}
    step = _step_line(name, trainer, batch, groups, seed, {"selective_scan": 2}, reps=3)
    device = device_profile(lambda: trainer.train_step(batch), step["step_parts_ms"]["step_ms"], reps=2, top=8)
    lines[name] = {"run_s": seconds, "launches_run": launches, "run_files": files["tags"], **step,
                   "device_ms_per_step": device["kernel_ms"], "busy_share": device["busy_share"], "device": device,
                   "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    by_path["fusion_train_vmamba"] = launches
    del trainer, batch, groups
    torch.cuda.empty_cache()
    for name, path in (("ham_fusion_crossattn_v1", "fusion_train_basic"),
                       ("spine_hierarchical_v1", "fusion_train_hierarchical")):
        trainer, launches, seconds, files, best[name] = _fusion_run(name, _phase_config(name, inputs, "train2"),
                                                                    2, 0)
        lines[name] = {"run_s": seconds, "launches_run": launches, "run_files": files["tags"],
                       "losses": [r["value"] for r in map(json.loads, Path(trainer.output_dir, "metrics.jsonl")
                                                          .read_text().splitlines()) if r["tag"] == "Loss/Train_Batch"]}
        by_path[path] = launches
        del trainer
        torch.cuda.empty_cache()
    layers = BertConfig().num_hidden_layers
    name = "ham_tta_attention_basic_mlp_v1"
    line, predictor, _, _ = _predict_line(dev, name, _phase_config(name, inputs), best["ham_fusion_crossattn_v1"],
                                          "baseline", {"attention_block": layers, "ffn_block": layers}, FUSION_VAL)
    lines[name] = {"checkpoint": "ham_fusion_crossattn_v1's best", **line}
    by_path["fusion_predict_tta"] = line["launches"]
    del predictor
    torch.cuda.empty_cache()
    return lines, by_path, best


def phase_fusion(dev, seed: int) -> dict:
    """The seven configurations of the baseline's remaining fusions on the card (FUSION_DIR): served,
    three trained, one predicted with TTA, vmamba's and hierarchical's exported at batch 64."""
    layers = BertConfig().num_hidden_layers
    return _phase(
        "fusion", FUSION_DIR, dev, seed, 90,
        lambda: _phase_inputs(FUSION_DIR, np.random.default_rng([seed, 80]), classes=(LABELS, 6)),
        lambda: _fusion_serve(dev, seed), lambda inputs: _fusion_train(dev, inputs, seed),
        lambda inputs: [(name, _phase_config(name, inputs), "baseline", BASELINE_BATCH, BASELINE_SEQ,
                         {"attention_block": layers, "ffn_block": layers, "selective_scan": scans})
                        for name, scans in (("ham_fusion_vmamba_v1", 2), ("spine_hierarchical_v1", 0))])


def _fusion_model(dev, seed: int):
    """ConNexT with the Mamba fusion at full width, bf16, seeded, its ConvNeXt layer scales at
    LAYER_SCALE (phase connext's weights: the map holds every block)."""
    cfg = load_config(REPO / "mdhs_tpu_torch" / "configs" / "connext_ham.json",
                      overrides=[f"{k}={str(v).lower()}" for k, v in FUSION_SETS.items()])
    model = init_parameters(build_model(cfg, "connext", load_tokenizer_for(cfg), device=dev, dtype=torch.bfloat16),
                            torch.Generator(device=dev).manual_seed(seed))
    with torch.no_grad():
        for p in _layer_scales(model):
            p.fill_(LAYER_SCALE)
    return model.eval()


def _mamba_serve(dev, seed: int) -> tuple[dict, dict]:
    """ham_mamba_vision_v1 through _serve_baseline (its logits against BERT's sublayers and against the
    scan alone on plain), and ConNexT with the Mamba fusion at batch 32, seq 512 with hidden vectors,
    live at full width, bf16, seeded: launches, the logits against BERT on plain and against the scan
    and kan_forward on plain, the fusion's output in float32 against its plain ops, _served_line's times."""
    layers = BertConfig().num_hidden_layers
    lines, by_path = {}, {}
    lines[MAMBA_VISION], by_path["mamba_serve_vision"] = _serve_baseline(
        dev, MAMBA_VISION, seed + 90, np.random.default_rng([seed, 90]), MV_SCANS,
        {"bert": BERT_128_BOUNDS, "scan": SCAN_BOUNDS})
    check(lines[MAMBA_VISION]["tower"] == ["mamba_vision_T", 640], f"{MAMBA_VISION}: tower {lines[MAMBA_VISION]['tower']}")
    mark("mamba/serve/vision")

    model = _fusion_model(dev, seed + 91)
    rng = np.random.default_rng([seed, 91])
    req = _request(rng, CONNEXT_BATCH, CONNEXT_SEQ)
    req.update({k: rng.standard_normal((CONNEXT_BATCH, LLM_HIDDEN)).astype(np.float32)
                for k in ("first_hidden", "last_hidden")})
    server = ServingModel(model, CONNEXT_BATCH, dev, image_size=CONNEXT_CROP, hidden=True)
    check(list(server.inputs)[-2:] == ["first_hidden", "last_hidden"], f"fusion server inputs {list(server.inputs)}")
    zero_counts()
    out = server.predict(req)
    launches = read_counts()
    by_layer = dict(ks.kan_forward.launches_by_layer)
    want = {**dict.fromkeys(KERNELS, 0), "fused_attention": layers, "ffn_block": layers, "selective_scan": 1,
            "kan_forward": FUSION_KAN}
    check(launches == want and by_layer == {(256, 256): FUSION_KAN} and out.shape == (CONNEXT_BATCH, LABELS)
          and bool(np.isfinite(out).all()), f"connext fusion launches {launches} {by_layer}, expected {want}")
    comparisons = {"bert": _vs_plain(server, req, out, launches, BERT_PLAIN_512, CONNEXT_LOGIT_MAX,
                                     CONNEXT_LOGIT_MEAN, "connext fusion"),
                   "scan_and_kan": _vs_plain(server, req, out, launches, FUSION_PLAIN, BF16_STEPS, BF16_MEAN,
                                             "connext fusion")}
    # the fusion alone in float32 on the served towers' outputs: kernels against plain ops, F32_FRAC
    with torch.inference_mode():
        images = eval_pipeline(torch.from_numpy(req["image"]).to(dev), CONNEXT_CROP, normalize=True,
                               dtype=torch.bfloat16)
        cls, fmap = model.towers(images, torch.from_numpy(req["input_ids"]).to(dev),
                                 torch.from_numpy(req["attention_mask"]).to(dev))
        f32 = copy.deepcopy(model.mamba_fusion).float()
        for m in f32.modules():
            if isinstance(m, KANLinear):  # its output dtype is the module's, bf16 as built
                m.out_dtype = torch.float32
        args = (cls.float(), fmap.float().flatten(1, 2), *(torch.from_numpy(req[k]).to(dev) for k in
                                                              ("first_hidden", "last_hidden")))
        fused = f32(*args)
        with contextlib.ExitStack() as stack:
            for module, op, plain in FUSION_PLAIN:
                stack.enter_context(_plain_op(module, op, plain))
            fused_plain = f32(*args)
    fmx, fmean, fbound, ok = judge_f32(fused, fused_plain)
    check(ok, f"connext fusion output in float32, kernels vs plain: max {fmx} (bound {fbound})")
    comparisons["fusion_output_f32"] = {"max_abs": fmx, "mean_abs": fmean, "max_abs_bound": fbound}
    lines["connext_mamba_fusion"] = {
        "model": "ConNexT: ConvNeXt-base (layer scales 0.5) + BERT-base, multimodal Mamba fusion (KAN attention "
                 "q/k/v 256 -> 256, Mamba d_inner 512 N 128 over 52 tokens), 3,584-wide hidden vectors, bf16, "
                 "batch 32, seq 512", **_served_line(server, req, out, launches, logits_vs_plain=comparisons)}
    by_path["mamba_serve_fusion"] = launches
    del model, server, f32
    torch.cuda.empty_cache()
    return lines, by_path


def _mamba_train(dev, inputs: dict, seed: int) -> tuple[dict, dict, dict]:
    """run_train of ham_mamba_vision_v1 (3 steps at batch 64: six scans a forward under autograd, their
    backward the associative scan's VJP) and _step_line against the plain scan; run_train --family
    connext with the Mamba fusion (2 steps at batch 32, the hidden JSON, one image without vectors) and
    _step_line against the plain scan and kan_forward; run_predict of the fusion with TTA and the
    hidden vectors over its best checkpoint (_predict_line), the vectors moving its logits. Returns
    the lines, the launches of each path and the best checkpoints."""
    lines, by_path, best = {}, {}, {}
    trainer, launches, seconds, files, best[MAMBA_VISION] = _fusion_run(
        MAMBA_VISION, _phase_config(MAMBA_VISION, inputs), 3, MV_SCANS)
    batch = next(iter(trainer.train_loader))
    params = dict(trainer.model.named_parameters())
    # the Mamba mixers of stages 3 and 4 (the attention blocks' mixer.qkv and mixer.proj left out)
    groups = {"mamba_vision_mixers": [p for n, p in params.items() if n.startswith("image_encoder.model.levels.")
                                      and ".mixer." in n and ".mixer.qkv." not in n and ".mixer.proj." not in n],
              "text_encoder": list(trainer.model.text_encoder.parameters())}
    lines[MAMBA_VISION] = {"run_s": seconds, "launches_run": launches, "run_files": files["tags"],
                           **_step_line(MAMBA_VISION, trainer, batch, groups, seed, {"selective_scan": MV_SCANS}),
                           "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    by_path["mamba_train_vision"] = launches
    del trainer, batch, groups, params
    torch.cuda.empty_cache()
    mark("mamba/train/vision")

    torch.cuda.reset_peak_memory_stats(dev)
    fusion_sets = {**FUSION_SETS, "data.llm_hidden_json": inputs["hidden_json"]}
    cfg = _phase_config("connext_ham", inputs, "train_cx", "val_cx", "connext_fusion", **fusion_sets)
    trainer, launches, seconds, files, best["connext_fusion"] = _fusion_run("connext fusion", cfg, 2, 1, "connext",
                                                                            FUSION_KAN)
    batches = list(trainer.train_loader)
    ids = [i for b in batches for i in b["image_id"]]
    row = [b["first_hidden"][b["image_id"].index(inputs["left_out"])] for b in batches
           if inputs["left_out"] in b["image_id"]]
    check(len(ids) == 2 * CONNEXT_BATCH and batches[0]["first_hidden"].shape == (CONNEXT_BATCH, LLM_HIDDEN)
          and len(row) == 1 and not row[0].any(), "connext fusion batches: the hidden vectors or the zero fill")
    params = dict(trainer.model.named_parameters())
    groups = {"kan_attention": [p for n, p in params.items() if n.startswith("mamba_fusion.attn.")],
              "mamba": [p for n, p in params.items() if n.startswith("mamba_fusion.mamba.")],
              "text_encoder": list(trainer.model.text_encoder.parameters())}
    lines["connext_fusion"] = {"run_s": seconds, "launches_run": launches, "run_files": files["tags"],
                               **_step_line("connext fusion", trainer, batches[0], groups, seed,
                                            {"selective_scan": 1, "kan_forward": FUSION_KAN},
                                            more=[(ks, "kan_forward", ks.kan_forward_reference)]),
                               "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    by_path["mamba_train_fusion"] = launches
    del trainer, batches, groups, params
    torch.cuda.empty_cache()
    mark("mamba/train/fusion")

    # run_predict with TTA and the test split's hidden vectors over the fusion's best checkpoint
    layers = BertConfig().num_hidden_layers
    cfg = _phase_config("connext_ham", inputs, "train_cx", "val_cx", "connext_fusion_tta", **fusion_sets,
                        **{"inference.tta.enabled": True, "inference.tta.transforms": list(CLI_TTA)})
    line, predictor, b, live = _predict_line(dev, "connext fusion", cfg, best["connext_fusion"], "connext",
                                             {"fused_attention": layers, "ffn_block": layers, "selective_scan": 1,
                                              "kan_forward": FUSION_KAN}, CONNEXT_BATCH)
    zeroed = predictor.server(cli_common.tta_transforms(predictor.cfg.get("inference.tta"))).predict(
        {**b, "first_hidden": np.zeros_like(b["first_hidden"]), "last_hidden": np.zeros_like(b["last_hidden"])}
    )[: int(b["n_valid"])]
    check(predictor.hidden and not np.array_equal(zeroed, live),
          f"connext fusion predictor: hidden {predictor.hidden}, or its vectors move no logit")
    lines["connext_fusion_predict"] = {"hidden": True, **line,
                                       "hidden_vectors_move_logits_max_abs": float(np.abs(zeroed - live).max())}
    by_path["mamba_predict_fusion"] = line["launches"]
    del predictor
    torch.cuda.empty_cache()
    return lines, by_path, best


def phase_mamba(dev, seed: int) -> dict:
    """MambaVision (ham_mamba_vision_v1) and ConNexT's multimodal Mamba fusion on the card (MAMBA_DIR):
    served, trained, the fusion predicted, both exported (MambaVision at batch 64, the fusion at batch
    32 with no hidden input); returns each path's launches."""
    layers = BertConfig().num_hidden_layers
    return _phase(
        "mamba", MAMBA_DIR, dev, seed, 96,
        lambda: _phase_inputs(MAMBA_DIR, np.random.default_rng([seed, 95]), hidden=("train_cx", "val_cx")),
        lambda: _mamba_serve(dev, seed), lambda inputs: _mamba_train(dev, inputs, seed),
        lambda inputs: [
            (MAMBA_VISION, _phase_config(MAMBA_VISION, inputs), "baseline", BASELINE_BATCH, BASELINE_SEQ,
             {"attention_block": layers, "ffn_block": layers, "selective_scan": MV_SCANS}),
            ("connext_fusion", _phase_config("connext_ham", inputs, "train_cx", "val_cx", "connext_fusion_export",
                                             **FUSION_SETS), "connext", CONNEXT_BATCH, CONNEXT_SEQ,
             {"fused_attention": layers, "ffn_block": layers, "selective_scan": 1, "kan_forward": FUSION_KAN})])


ANALYSIS_DIR = REPO / "mdhs_tpu_torch" / "build" / "analysis_smoke"  # git-ignored; removed when the phase ends
# 96 test records (two batches of 64, the second padded) over 48 seeded PNGs, each under two names; 80 CAMs
ANALYSIS_RECORDS, ANALYSIS_PNGS, ANALYSIS_CAMS = 96, 48, 80
# (configuration, its launches_by_path name, selective_scan a forward): base.yml (ResNet18, multiscale, GroupKAN)
# and MambaVision-T (basic fusion), both with BERT-base at seq 128, batch 64
ANALYSIS_CONFIGS = (("ham_base", "analysis_base", 0), (MAMBA_VISION, "analysis_mamba_vision", MV_SCANS))
# a CAM step's averaged CAM, kernel route against plain route, on the rows both routes give one class (the mean and
# max |d| of a row's 224 x 224 map in [0, 1]): at least CAM_SHARE of them within the first guess at the bf16 noise
# (CAM_MEAN, CAM_MAX) and every one within CAM_MEAN_ALL, CAM_MAX_ALL, widened on the card's reading (PERF.md's
# findings: a few rows in 64 moved to a mean of 0.038 and a max of 0.136); the feature rank's relative bound
CAM_MEAN, CAM_MAX, CAM_SHARE, RANK_REL = 2.0 ** -7, 2.0 ** -3, 0.75, 0.01
CAM_MEAN_ALL, CAM_MAX_ALL = 2.0 ** -4, 2.0 ** -2


def _analysis_inputs(rng) -> dict:
    """ANALYSIS_RECORDS records over ANALYSIS_PNGS seeded 600 x 450 PNGs in ANALYSIS_DIR, a JSON of their
    descriptions (8-300 words) and a label CSV of all of them."""
    img_dir = ANALYSIS_DIR / "images"
    img_dir.mkdir(parents=True)
    names = [f"ISIC_{i:07d}.png" for i in range(ANALYSIS_RECORDS)]
    for i, name in enumerate(names):
        if i < ANALYSIS_PNGS:
            png.write_png(str(img_dir / name), _cli_image(rng))
        else:
            shutil.copyfile(img_dir / names[i % ANALYSIS_PNGS], img_dir / name)
    (ANALYSIS_DIR / "descriptions.json").write_text(json.dumps(
        [{"image_info": n, "description": " ".join(rng.choice(CLI_WORDS, int(rng.integers(8, 300))))} for n in names]))
    (ANALYSIS_DIR / "labels.csv").write_text(
        "image_id,label\n" + "".join(f"{n},{int(rng.integers(0, LABELS))}\n" for n in names))
    return {"image_dir": str(img_dir), "json_path": str(ANALYSIS_DIR / "descriptions.json"),
            "label_csv": str(ANALYSIS_DIR / "labels.csv")}


def _analysis_run(dev, smi: str, name: str, scans: int, inputs: dict, seed: int) -> tuple[dict, dict]:
    """run_analysis of mdhs_tpu_torch/configs/<name>.json over the test records with seeded full-width bf16
    weights (a port checkpoint): launches (a feature forward and a CAM step each of the two batches), the
    80 overlays read back, the printed line; then on the first batch a CAM step against the same step with
    BERT's sublayers (and the scan) on their plain versions: the logits (BF16_STEPS of the largest), the
    averaged CAM on the rows of one class (CAM_*), the feature rank (RANK_REL); the CAM step's
    and the feature forward's ms, device ms, busy share and peak memory. Returns the line and the launches."""
    layers = BertConfig().num_hidden_layers
    cfg = load_config(REPO / "mdhs_tpu_torch" / "configs" / f"{name}.json")
    for key, value in (("data.test_image_dir", inputs["image_dir"]), ("data.test_json_path", inputs["json_path"]),
                       ("data.test_label_csv", inputs["label_csv"]), ("output.log_dir", str(ANALYSIS_DIR / "runs"))):
        cfg.set(key, value)
    cfg_path = str(ANALYSIS_DIR / f"{name}.json")
    cfg.save_json(cfg_path)
    model = init_parameters(build_model(cfg, "baseline", load_tokenizer_for(cfg), device=dev, dtype=torch.bfloat16),
                            torch.Generator(device=dev).manual_seed(seed)).eval()
    ckpt = str(ANALYSIS_DIR / f"{name}.pt")
    save_checkpoint(ckpt, model, {"name": name})
    del model
    torch.cuda.empty_cache()
    out_dir = ANALYSIS_DIR / f"{name}_out"
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        result = run_analysis.main(["--config", cfg_path, "--model_path", ckpt, "--output_dir", str(out_dir),
                                    "--num_cam_images", str(ANALYSIS_CAMS), "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    run_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    last = printed.getvalue().strip().splitlines()[-1]
    a_forward = {"attention_block": layers, "ffn_block": layers, "selective_scan": scans}
    want = {**dict.fromkeys(KERNELS, 0), **{k: 4 * v for k, v in a_forward.items()}}
    check(launches == want, f"{name} run_analysis launches {launches}, expected {want}")
    check(last == f"effective rank: {result['effective_rank']:.1f}; rank@1%: {result['rank_at_1pct']}; "
                  f"CAMs written: {ANALYSIS_CAMS}", f"{name} run_analysis printed {last!r}, returned {result}")
    mark(f"analysis/{name}/run")

    predictor = cli_common.build_predictor(cfg_path, device=dev)
    predictor.load_weights(ckpt)
    model, size = predictor.model, predictor.image_size
    loader = predictor.make_test_loader()
    batches = list(loader)
    ids = [m["image_id"] for m in loader.dataset.metadata[:ANALYSIS_CAMS]]
    files = sorted(p.name for p in out_dir.glob("cam_*.png"))
    overlays = [png.read_png(str(out_dir / f)) for f in files]
    check(len(batches) == 2 and files == sorted(f"cam_{i}.png" for i in ids)
          and all(o.shape == (size, size, 3) and o.dtype == np.uint8 for o in overlays),
          f"{name}: {len(files)} overlays {files[:3]}, expected cam_<id>.png of the first {ANALYSIS_CAMS} records")
    staged = [run_analysis.batch_inputs(b, model, dev, size) for b in batches]
    images, ids_t, mask, tab = staged[0]
    step = lambda: run_analysis.cam_step(model, images, ids_t, mask, tab, size)  # noqa: E731
    zero_counts()
    cams, logits = step()
    step_launches = read_counts()
    check(step_launches == {**dict.fromkeys(KERNELS, 0), **a_forward},
          f"{name} CAM step launches {step_launches}, expected {a_forward}")
    routes = BERT_PLAIN_128 + (SCAN_PLAIN if scans else [])
    with contextlib.ExitStack() as stack:
        for module, op, plain in routes:
            stack.enter_context(_plain_op(module, op, plain))
        zero_counts()
        cams_p, logits_p = step()
        plain_counts = read_counts()
        rank_p = FeatureRankAnalyzer()
        with torch.inference_mode():
            for (im, i_, m_, t_), b in zip(staged, batches):
                rank_p.add(model.forward_features(im, i_, m_, tabular=t_).float().cpu().numpy()[: int(b["n_valid"])])
    check(all(plain_counts[op] == 0 for _, op, _ in routes), f"{name} plain CAM step launches {plain_counts}")
    lmax, lmean = diff(logits, logits_p)
    scale = float(logits_p.float().abs().max())
    check(lmax <= BF16_STEPS * scale, f"{name} CAM step logits kernels vs plain: max {lmax} (bound {BF16_STEPS * scale})")
    same = (logits.argmax(-1) == logits_p.argmax(-1)).cpu()
    d = (cams - cams_p).abs().flatten(1).cpu()
    row_mean, row_max = d.mean(dim=1)[same], d.amax(dim=1)[same]
    n_same = int(same.sum())
    under_mean, under_max = int((row_mean <= CAM_MEAN).sum()), int((row_max <= CAM_MAX).sum())
    check(n_same >= 1 and min(under_mean, under_max) >= CAM_SHARE * n_same
          and float(row_mean.max()) <= CAM_MEAN_ALL and float(row_max.max()) <= CAM_MAX_ALL,
          f"{name} CAMs kernels vs plain on {n_same} rows of one class: {under_mean} within mean |d| {CAM_MEAN}, "
          f"{under_max} within max |d| {CAM_MAX} (at least {CAM_SHARE} of them); every row's mean |d| "
          f"{row_mean.tolist()} (bound {CAM_MEAN_ALL}), max |d| {row_max.tolist()} (bound {CAM_MAX_ALL})")
    eff_p = rank_p.compute()["effective_rank"]
    check(abs(result["effective_rank"] - eff_p) <= RANK_REL * eff_p,
          f"{name} effective rank {result['effective_rank']} against {eff_p} with the plain routes")
    mark(f"analysis/{name}/vs_plain")

    cam_ms = cuda_ms(step, reps=3)
    torch.cuda.reset_peak_memory_stats(dev)
    step()
    torch.cuda.synchronize()
    cam_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    cam_device = device_profile(step, cam_ms, reps=2, top=6)

    def feature_forward():
        with torch.inference_mode():
            return model.forward_features(images, ids_t, mask, tabular=tab)

    feature_ms = cuda_ms(feature_forward, reps=5)
    feature_device = device_profile(feature_forward, feature_ms, reps=2, top=6)
    line = {"config": name, "tower": [model.cfg.image_backbone, model.cfg.fusion_type, model.cfg.classifier_type],
            "nvidia_smi": smi, "run_s": seconds, "launches": launches, "printed": last,
            "effective_rank": result["effective_rank"], "rank_at_1pct": result["rank_at_1pct"],
            "overlays": len(files), "cam_step_launches": step_launches,
            "vs_plain": {"plain": [op for _, op, _ in routes], "logits_max_abs": lmax, "logits_mean_abs": lmean,
                         "max_abs_logit": scale, "rows": len(same), "rows_same_class": int(same.sum()),
                         "rows_under_cam_mean": under_mean, "rows_under_cam_max": under_max,
                         "cam_mean_abs_max_row": float(row_mean.max()), "cam_max_abs_max_row": float(row_max.max()),
                         "effective_rank_plain": eff_p},
            "cam_step_ms": cam_ms, "cam_step_device_ms": cam_device["kernel_ms"],
            "cam_step_busy_share": cam_device["busy_share"], "cam_step_peak_memory_gib": cam_peak,
            "run_peak_memory_gib": run_peak, "feature_forward_ms": feature_ms,
            "feature_forward_device_ms": feature_device["kernel_ms"],
            "feature_forward_busy_share": feature_device["busy_share"],
            "device": {"cam_step": cam_device, "feature_forward": feature_device}}
    del predictor, model, batches, staged, cams, cams_p
    torch.cuda.empty_cache()
    return line, launches


def _torchvision_tower(sd: dict) -> dict:
    """ConNexT's state dict with its HF-named ConvNeXt tower under torchvision's ``features.*`` names
    (``convert_convnext_torchvision``'s table; the layer scale (C, 1, 1)), the rest unchanged."""
    out = {}
    for k, v in sd.items():
        if not k.startswith("image_encoder."):
            out[k] = v
            continue
        p = k.split(".")[1:]
        if p[0] == "embeddings":
            tv = f"0.{0 if p[1] == 'patch_embeddings' else 1}.{p[-1]}"
        elif p[3] == "downsampling_layer":
            tv = f"{2 * int(p[2])}.{p[4]}.{p[5]}"
        elif p[5] == "layer_scale_parameter":
            tv, v = f"{1 + 2 * int(p[2])}.{p[4]}.layer_scale", v.reshape(-1, 1, 1)
        else:
            index = {"dwconv": 0, "layernorm": 2, "pwconv1": 3, "pwconv2": 5}[p[5]]
            tv = f"{1 + 2 * int(p[2])}.{p[4]}.block.{index}.{p[6]}"
        out["image_encoder.features." + tv] = v
    return out


def _connext_reference(dev, seed: int) -> dict:
    """A seeded full-width ConNexT (connext_ham.json, bf16, layer scales LAYER_SCALE) saved as a reference
    file twice, bare and as a Lightning checkpoint under ``net.net.`` with its tower under torchvision's
    names; each loaded by load_weights into the model re-seeded in between: the served logits at batch 32,
    seq 512 bit for bit the same for both, and not those of the re-seeded weights."""
    cfg = load_config(REPO / "mdhs_tpu_torch" / "configs" / "connext_ham.json")
    model = init_parameters(build_model(cfg, "connext", load_tokenizer_for(cfg), device=dev, dtype=torch.bfloat16),
                            torch.Generator(device=dev).manual_seed(seed)).eval()
    with torch.no_grad():
        for p in _layer_scales(model):
            p.fill_(LAYER_SCALE)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    files = {"bare": ANALYSIS_DIR / "connext_bare.pth", "net.net.+torchvision": ANALYSIS_DIR / "connext_ref.ckpt"}
    torch.save(sd, files["bare"])
    torch.save({"state_dict": {"net.net." + k: v for k, v in _torchvision_tower(sd).items()}, "epoch": 0},
               files["net.net.+torchvision"])
    req = _request(np.random.default_rng([seed, 97]), CONNEXT_BATCH, CONNEXT_SEQ)
    server = ServingModel(model, CONNEXT_BATCH, dev, image_size=CONNEXT_CROP)
    out = {}
    for tag, path in files.items():
        init_parameters(model, torch.Generator(device=dev).manual_seed(seed + 1))
        out["reseeded"] = server.predict(req)
        load_weights(model, str(path), "connext")
        out[tag] = server.predict(req)
    check(np.array_equal(out["bare"], out["net.net.+torchvision"]) and not np.array_equal(out["bare"], out["reseeded"])
          and bool(np.isfinite(out["bare"]).all()),
          "connext: the net.net. / torchvision reference file's logits are not the bare file's bit for bit")
    del model, server
    torch.cuda.empty_cache()
    return {"files": list(files), "tensors": len(sd), "logits_bit_equal": True,
            "max_abs_logit": float(np.abs(out["bare"]).max())}


def phase_analysis(dev, smi: str, seed: int) -> dict:
    """run_analysis on the card (ANALYSIS_DIR) for each of ANALYSIS_CONFIGS, and the reference ConNexT
    checkpoint read as the JAX package reads it (_connext_reference); returns each path's launches."""
    shutil.rmtree(ANALYSIS_DIR, ignore_errors=True)
    ANALYSIS_DIR.mkdir(parents=True)
    t_phase = time.perf_counter()
    try:
        inputs = _analysis_inputs(np.random.default_rng([seed, 98]))
        mark("analysis/inputs")
        by_path = {}
        for i, (name, path, scans) in enumerate(ANALYSIS_CONFIGS):
            line, by_path[path] = _analysis_run(dev, smi, name, scans, inputs, seed + 98 + i)
            emit({"phase": "analysis", **line})
            mark(f"analysis/{name}")
        emit({"phase": "analysis", "connext_reference": _connext_reference(dev, seed + 99),
              "phase_seconds": time.perf_counter() - t_phase})
    finally:
        shutil.rmtree(ANALYSIS_DIR, ignore_errors=True)
    return by_path


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    seed = parser.parse_args().seed
    rng = np.random.default_rng(seed)

    seconds = {}
    clock = [time.perf_counter()]

    def timed(name, fn, *args):
        out = fn(*args)
        now = time.perf_counter()
        seconds[name], clock[0] = now - clock[0], now
        return out

    dev, smi = timed("device", phase_device)
    timed("build", phase_build)
    summary = timed("kernels", phase_kernels, dev, rng, seed)
    summary["attention_ablate"], ablate_launches = timed("ablate", phase_ablate, dev, rng)
    slice_launches, model, plain = timed("slice", phase_slice, dev, rng, seed)
    seq512_launches = timed("seq512", phase_seq512, dev, rng, model, plain)
    flash_launches = timed("flash", phase_flash, dev, rng, model)
    del model, plain
    torch.cuda.empty_cache()
    preset_launches = timed("preset", phase_preset, dev, rng, seed)
    torch.cuda.empty_cache()
    baseline = timed("baseline", phase_baseline, dev, rng, seed)
    train = timed("train", phase_train, dev, rng, seed)
    train_flash = timed("train_flash", phase_train_flash, dev, rng, seed)
    connext = timed("connext", phase_connext, dev, seed)
    train_connext = timed("train_connext", phase_train_connext, dev, seed)
    train_baseline = timed("train_baseline", phase_train_baseline, dev, seed)
    try:
        cli, made = timed("cli", phase_cli, dev, seed)
        cli.update(timed("train_cli", phase_train_cli, dev, made["inputs"],
                         torch.Generator(device=dev).manual_seed(seed + 35)))
        cli.update(timed("train_baseline_cli", phase_train_baseline_cli, dev, made["inputs"]))
        export = timed("export", phase_export, dev, seed, made)
    finally:
        shutil.rmtree(CLI_DIR, ignore_errors=True)
    spine = timed("spine", phase_spine, dev, seed)
    fusion = timed("fusion", phase_fusion, dev, seed)
    mamba = timed("mamba", phase_mamba, dev, seed)
    analysis = timed("analysis", phase_analysis, dev, smi, seed)
    emit({"phase_seconds": seconds, "total_seconds": sum(seconds.values()),
          "line_seconds": [[label, round(t, 2)] for label, t in SPANS]})
    main_path = {"attention_block": slice_launches, "ffn_block": slice_launches,
                 "fused_attention": seq512_launches, "int8_ffn_block": preset_launches,
                 "int8_attention_block": preset_launches, "shear_sublane": train["launches"],
                 "bn_stats": train["ab_launches"], "bn_stats_backward": train["ab_launches"], **baseline, "flash_attention": flash_launches,
                 "flash_attention_bwd_dkv": train_flash, "flash_attention_bwd_dq": train_flash,
                 "attention_ablate": {"attention_ablate": ablate_launches}}
    # every path's launches of each kernel, each counted from 0 just before that path ran
    by_path = {"slice": slice_launches, "seq512": seq512_launches, "preset": preset_launches,
               "baseline_ssm": baseline["selective_scan"], "baseline_moe": baseline["kan_forward"],
               "train": train["launches"], "train_bn_stats": train["ab_launches"], "flash": flash_launches,
               "train_flash": train_flash, "ablate": {"attention_ablate": ablate_launches},
               "connext": connext["launches"], "train_connext": train_connext, **train_baseline, **cli, **export,
               **spine, **fusion, **mamba, **analysis}
    # each layer's launches on the path that serves it: the baseline MoE's two, ConNexT's four, the fusion's q/k/v
    kan_by_layer = {**baseline["kan_forward_by_layer"], **connext["kan_forward_by_layer"],
                    (256, 256): mamba["mamba_serve_fusion"]["kan_forward"]}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": main_path[name][name], "max_abs_err": summary[name]["max_abs_err"],
         "ms": summary[name]["ms"], "device_ms": summary[name]["device_ms"], "plain_ms": summary[name]["plain_ms"],
         "bound_ms": summary[name]["bound_ms"], "bound_by": summary[name]["bound_by"],
         "library_ms": summary[name]["library_ms"], "library_device_ms": summary[name]["library_device_ms"],
         "launches_by_path": {path: counts[name] for path, counts in by_path.items() if counts.get(name)}}
        | ({"layers": [{**layer, "launches": kan_by_layer.get(tuple(layer["in_out"]), 0)}
                       for layer in summary["kan_forward_layers"]]} if name == "kan_forward" else {})
        for name, (_, src, rep) in KERNELS.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
