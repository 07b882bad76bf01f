#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's continuum, RRL, emergent, pipeline,
synthetic-observation, line-cube observation, analysis, command-line,
fitting and parallel main paths and its examples once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. kernels: build every kernel of ``rajepy_tpu_torch/csrc/`` and hold each
   against its plain PyTorch version on the card, on small random inputs:
   the epoch kernels with fully empty tiles and negative travel times (the
   tile kernel, with one base and with two, on segments of 1 to 3 tiles
   out of segment order and tile positions with no tile, which must hold
   exact zeros, two calls bit-identical, the one-base map of each base bit
   for bit the two-base kernel's, and the per-tile partials), burst_chi
   alone against its
   plain version, the RRL kernels (maps on tiles, per-tile partials, the
   full grid and its activity pass) with an empty tile, a wholly jet
   tile, segments of several tiles out of segment order, tile positions
   with no tile, a ragged grid with an amp = 0 slab and wholly jet x rows,
   channel sets that are all-far, all-near and mixed, and 1, 33 and 1000
   channels (exact zeros where no jet cell lies); the emergent kernels
   with fully empty tiles, segments of one and of several tiles, negative
   travel times, a ragged grid, zero-opacity y ranges and both observer
   orientations (1e-5 of the plain map's maximum; the tile kernel at 1, 5,
   6, 16, 64 and 70 channels, tau up to ~1e5), and the emergent
   tile and full-grid kernels against the float64 host oracle (1e-5); the
   two
   full-grid kernels that stream base through a shared-memory ring (epoch
   and emergent) also on a grid with nz % 4 != 0, a wholly jet cube, a cube
   whose only jet cells lie in the last y row and the last z column, an
   all-zero cube with launch times that are not finite (exact zeros),
   a view that is not 16-byte aligned, and 1, 17 and 64 channels; the
   Faddeeva kernel (``ops/voigt.wofz`` on card tensors) in float64 and
   float32 across the interior, both sides of the wings' cut, y < 3e-5
   and y = 0, |x| up to 1e4 and on expanded inputs (1e-13 and 1e-5 of
   |w|, each element);
2. main paths, each counted: the launch counters are reset just before a
   path and read just after, and each of its kernels must have been
   launched.
   a. continuum: the bundled example jet at 512^3 cells, float32
      (``dtype='auto'``), 16 channels: ``continuum_rt_products`` at three
      epochs, ``flux_ff`` with a FITS product and ``emission_measure``
      (equal to the last epoch's flux and EM bit for bit);
      then a 512^3 grid that holds no jet cell (the full-grid branch);
   b. RRL: the same jet at 2.0 yr, H58a over the pipeline's band (nu0 +-
      5e7 Hz, 1000 channels): ``rrl_rt_products`` LTE and non-LTE (table
      departure coefficients), ``optical_depth_rrl`` on 16 channels over
      nu0 (1 +- 1e-4) with a FITS product, ``flux_rrl`` on those 16
      channels with the continuum, and the jet-free 512^3 grid through
      ``rrl_rt_products`` (the full-grid RRL branch);
   c. emergent: the same jet at 2.2 yr, ``emergent_intensity_ff`` on the 16
      continuum channels (the compacted tile kernel), the jet-free 512^3
      grid (the full-grid kernel), and the ordered-scan op
      ``transfer_scan_maps`` on one channel's 512^3 source and opacity
      cubes, the channel chosen so that tau reaches 1 on the map;
   d. pipeline: ``Pipeline(jm, params).execute(simobserve=False,
      plot=False)`` on the same 512^3 float32 model with the bundled
      ``example-pipeline-params.py`` (``rrls.times`` set to [2.0]: the file
      ships with no RRL epoch): six continuum runs (0-5 yr at 6 GHz) and
      one H58a run of 1000 channels.  The dual-base epoch kernel must have
      been launched once per run and the RRL tile kernel once; every run's
      three FITS files under ``Day<d>/<freq|line>/`` must equal the direct
      ``continuum_rt_products``/``rrl_rt_products`` call to 1e-6 of the
      map's maximum (the same code and, since the epoch kernel sums in a
      fixed order, the same bits; the largest difference is printed); a
      second ``execute`` must launch nothing and rewrite no file,
      ``Pipeline.load_pipeline`` must give the same run table, and
      ``clobber=True`` on one run must recompute it.  Prints every run's
      device-compute, copy-out, FITS-write and checkpoint times.
   e. synthetic observations: ``Pipeline(jm, params).execute(resume=False,
      clobber=True)`` (``simobserve`` at its default, True, and ``plot``
      at its default, True, where matplotlib can be imported, else False:
      an early line says which) on the same model with the bundled
      ``example-pipeline-params.py`` as shipped: six continuum runs (0-5
      yr, VLA A, 6 GHz, 2 channels), each observed (718,848
      visibilities, a 500 x 500 image, 500 Hogbom
      iterations at most) in float64 on the card.  The dual-base epoch
      kernel must have been launched 6 times; every run must complete with
      its visibility sets, restored image (Jy/beam, with its beam),
      ``.estimates`` and ``.imfit``; with ``plot=True``, ``GridPlot.pdf``,
      ``JMLPlot.pdf``, each epoch's ``ModelPlot.pdf`` and each epoch's
      ``RadioSED<year>yrPlot.png`` (the stage ``plots`` is printed with
      the others); std(noisy - clean) of each part within
      1% of sigma.  Run 1 through the synthobs functions on the card and
      on the CPU, each stage from the same inputs: the clean visibilities
      (also bit for bit the pipeline's), the dirty image and PSF, and the
      restored image to 1e-10 of their peaks, ``hogbom_clean`` bit for bit
      with the same iteration count.  A second ``simulate_observation`` of
      run 1 must give the same visibilities and image bit for bit, and a
      resumed ``execute`` must launch and rewrite nothing.  Prints every
      run's stages, the imfit peak and flux, each stage's time on both
      devices, the Hogbom loop's iterations per second and peak memory.
      The other mfs deconvolvers on run 1: ``clark_clean`` and
      ``multiscale_clean`` on its dirty image and PSF, ``mtmfs_clean`` on
      its two channels' Taylor stacks, each on the card and on the CPU
      from the same inputs (the same count; model and residual to 1e-10
      of the dirty peak), with their times.
   f. line-cube observation: ``Pipeline(jm, params).execute(plot=False,
      resume=False, clobber=True)`` on the same model with the bundled
      pipeline params' H58a run alone (``rrls.times = [2.0]``, no
      continuum epoch): 1000 channels of 1e5 Hz observed with VLA A for
      30,000 s of 60 s integrations (500 time samples x 351 baselines a
      channel, with noise), imaged at 500 x 500 by ``clean_cube`` (Briggs
      0.5, the channel-batched Hogbom, 500 iterations at most, 3 sigma).
      The dual-base epoch kernel and the RRL tile kernel must each have
      been launched once; the run must complete with its two visibility
      sets and a (1000, 500, 500) restored FITS cube with its FREQ axis,
      equal to the cube in memory.  ``clean_cube`` on 8 channels around
      nu0 on the card and on the CPU: restored and dirty cubes to 1e-10 of
      each channel's peak, the batched Hogbom on the card's inputs bit for
      bit on the CPU, a repeat and blocks of 3 channels bit for bit on the
      card.  Prints the stages (uv tracks, sampling, npz write, cube
      imaging with its prep, CLEAN and restore, FITS write), the channel
      block, the batched loop's iterations and channel-iterations per
      second and peak memory.
   g. diagnostics and analysis: ``models.analysis.light_curve`` of the
      same model over 50 epochs from 0 to 5 yr (across its four bursts)
      and the 16 continuum channels: the single-base epoch kernel must
      have been launched once per epoch, and the brightest epoch must
      equal the kernel's plain version followed by the channel stage on
      the same card tensors (2e-4).  Timed by CUDA events (median of 5,
      the copy to the host included): ``diagnostic_maps``,
      ``occupancy_projections``, ``conservation_profiles``,
      ``velocity_midplane``, ``chi_xyz``, ``number_density``, ``sed``,
      ``spectral_index_map``, ``turnover_map`` and ``light_curve``, with
      peak memory; each held at 128^3 against the same call of a float32
      CPU model (1e-5 of the CPU's largest magnitude, NaN in the same
      cells).
   h. the CLI with calibration and export: ``rajepy_tpu_torch.main.main(
      ['-rt', '-so', '-c', model, pipeline])`` in this process, with a
      model param file of the example jet at 512^3 (``dtype='auto'``) and
      the bundled ``example-pipeline-params.py`` as shipped (six
      continuum runs, VLA A, 6 GHz, 59,400 s of 5 s integrations, 2
      channels) plus its documented ``params['synthobs']`` block
      (tsys-atm noise, Briggs 0.5, 500 iterations, phase corruption of 30
      deg rms with a 600 s coherence time, two rounds of phase-only
      selfcal at a 300 s solution interval) and ``export_uvfits``.  The
      dual-base epoch kernel must have been launched 6 times; every run
      must complete with its clean, noisy and selfcal sets, its gains
      (198 intervals, unit modulus), two UVFITS files, restored image and
      imfit, a finite dynamic range before and after each round; the
      param files and the ``ModelRun_*.log`` in ``model_dcy``; run 1's
      UVFITS files equal to its npz sets to float32 rounding.  On run 1's
      corrupted noisy set and the CLEAN model of its first imaging, card
      against CPU from the same inputs (1e-10 of the largest magnitude):
      ``model_vis``, ``solve_gains`` (phase, amp+phase, per channel),
      ``correct_vis``, ``closure_phases``, ``log_closure_amplitudes``,
      ``sample_vis_dft`` and ``sample_vis_dft_w`` on the model's 64^2
      centre at 4,096 visibilities; two solves on the card bit-identical
      (a solve's device operations are counted by the profiler at the end
      of phase 3, after its other sessions).  Run 1 again through
      ``reuse_vis`` must give the same gains and image bit for bit; run 2
      with run 1's gains transferred must complete and log it; and
      ``python -m rajepy_tpu_torch.main`` with no arguments (the bundled
      files' dry run, ``HOME`` in the script's temporary directory) must
      exit 0 and write no FITS file.  Prints the CLI's wall time, each
      run's new stages, each calibration call's time on both devices and
      peak memory.
   i. the fits (``rajepy_tpu_torch.fit``) at the flagship's width, the
      model float32: ``fit_joint`` with one ``sed`` component of the 16
      continuum channels, ``dtype=torch.float32``, mlr_bj and T_0 free,
      20 Adam steps from mlr_bj x 1.3, T_0 x 0.7 of the truth, with its
      step-0 gradient against the card's float64 gradient (1e-3); the
      same fit in float64 at 64^3, card against CPU (loss history, final
      theta and gradient to 1e-10); ``fit_light_curve`` over the 50
      epochs x 16 channels, 20 steps; ``fit_rrl_spectrum`` (H58a, 9
      channels across the line, float64 with remat), 3 steps;
      ``fit_visibilities`` on phase 2e's run 1 uv tracks (one channel),
      3 steps, and ``closure_uncertainties`` on its first 64 integrations
      at 64^3, card (theta a tensor there) against CPU (1e-8);
      ``laplace_uncertainties`` at the first fit's end, theta as numpy and
      as a tensor on the card (1e-12), and a ``sweep`` of 8 combos (the
      truth's combo equal to the forward).  Every loss must fall; the
      steps are timed by CUDA events recorded by the optimizer (median),
      with each fit's own peak memory above what was resident before
      it.  Of the hand-written kernels the fits launch the Faddeeva
      one alone, in the RRL fit (``launches_by_path.fit``): their other
      forwards are plain torch, as the JAX package's fit forwards are
      XLA (the Pallas kernels have no VJP).
   j. parallel (``rajepy_tpu_torch.parallel``) on the same model: meshes of
      4 shards, all on the one card (an early line says so: no speed-up
      is measured, and no copy between cards is made), (n_chan, n_los) =
      (2, 2) for the LOS and channel functions and 4 along runs, epochs,
      starts and combos.  ``sharded_static_fields`` must equal the model's
      fill bit for bit, with ``fill_memory_stats``' per-shard peak below
      the whole fill's; ``sharded_rt_products`` on the 16 continuum
      channels the single-device ops to 1e-5 of each map's maximum (the
      float32 order of the LOS sum); ``sharded_rrl_tau_maps`` on phase
      2b's 16 H58a channels the cube kernel on the whole grid (1e-5),
      launching it once per shard; ``sharded_transfer_scan`` on phase 2c's
      cubes the scan op on the whole cube (2e-4), launching it once per
      shard; ``sharded_epoch_base_map_tiles`` the single-base epoch
      kernel's map and ``light_curve_sharded`` over the 50 epochs
      ``light_curve``, both bit for bit; ``sharded_clean_cube`` on phase
      2f's 8 channels ``clean_cube`` bit for bit; ``continuum_runs_fanout``
      over phase 2d's six continuum runs each run's
      ``continuum_rt_products`` bit for bit (the dual-base kernel launched
      6 times), and ``rrl_runs_fanout`` of two 1000-channel H58a epochs,
      LTE and non-LTE, ``rrl_rt_products`` bit for bit.
      ``Pipeline.execute(simobserve=False, plot=False)`` with the device
      list replaced (the bundled params, no RRL epoch) must log "Fanned 6
      continuum runs" and write the direct calls' maps bit for bit; after
      two runs' flux FITS are deleted a resumed ``execute`` must fan and
      write those two alone; ``device_fanout=False`` must launch once per
      run and fan nothing.  ``fit_joint``'s SED fit with 4 starts (3
      steps) and a ``sweep`` of 8 combos (whole and in batches of 3), each
      with ``mesh=``, must equal ``mesh=None`` bit for bit.  Each
      function's launches count as ``launches_by_path.parallel``; prints
      each one's time, the six runs fanned and one by one, and the peak
      memory.
   k. the examples (``rajepy_tpu_torch.examples``), each
      ``main(device='cuda')`` in this process at the JAX example's own
      sizes and step counts (but the step cuts of EXAMPLE_KWARGS in
      ``fit_parameters`` and ``wide_field_vlbi``), each counted alone
      (``launches_by_path.examples``), with its wall time, report and peak
      memory above what was resident: ``single_chip_production`` (a second
      512^3 float32 model, c_size 0.25 au; the single-base epoch kernel and
      the RRL tile kernel must be launched; its SED equal to the sums of
      ``flux_ff`` of the same model to 1e-6, its 128-channel H58a cube the
      RRL tile kernel's plain version on the same card tensors and its
      brightest light-curve epoch the plain epoch path, 2e-4; each
      section's time), ``multi_chip_sharded`` with the device list
      replaced by four shards of the card (the dual-base epoch kernel must
      be launched; its EM, tau and flux maps the single-device ops on the
      model's own fill to 1e-5, its light curve and fanned runs
      ``light_curve`` and ``continuum_rt_products`` bit for bit),
      ``nonlte_and_surveys`` (its float32 line-centre fluxes against the
      same calls on the card in float64, 1e-5, and with per-sightline
      departure maps 1e-3, and in float32 through the RRL tile kernel's
      plain version, 2e-4), ``fit_parameters``, ``calibration_workflow``
      (the selfcal dynamic range rising every round), ``uvfits_interchange``
      (the file read back with the sizes the run wrote) and
      ``wide_field_vlbi`` (the w-stacked error below 1e-3 of the total
      flux, the coplanar one above); every noise-free fit within 2% of the
      truth it prints, its loss falling, and its wall time over its steps
      printed.  In the six small examples each epoch and RRL tile kernel's
      first launch (copies of its card tensors, kept by a wrapper of the
      kernel's wrapper) is held against its plain version, 2e-4.  Then
      ``python -m rajepy_tpu_torch.examples.nonlte_and_surveys`` in its
      own process must exit 0.
   Outputs must be finite, non-zero where the jet is (all-zero on the
   jet-free grid), equal to the plain versions on the same card tensors
   (2e-4), and a small model at float32 must agree with the float64 plain
   path (2e-4 continuum, 1e-3 RRL, 3e-3 emergent on axis and at inc 55 /
   pa 30).  Each kernel is also held against its plain version at the main
   path's shapes (1e-5); the emergent full-grid kernel on the flagship's
   own cubes against the tile kernel's maps, and the scan op against that
   channel of the full-grid kernel's maps (2e-4: two implementations of
   one image).
3. numbers: the GPU's name and power limit, n_act, fill time and peak
   memory, the warm per-epoch time of ``continuum_rt_products``, per-run
   time of ``rrl_rt_products`` and per-call time of the emergent maps
   (CUDA events), the emergent compaction's tiles and segments, device
   busy time and device operations per call under ``torch.profiler``, and
   each kernel's time beside its plain version's and its bound (the larger
   of bytes over 3.35 TB/s and float32 operations over 67 TFLOP/s, the
   H100 SXM data sheet's peaks; for the emergent tile kernel also its
   special-function work at 16 a clock per SM).  A kernel's time in the
   summary line is its device time by the profiler; CUDA events around
   back-to-back calls are printed beside it (they hold the wrapper's host
   time where that exceeds the kernel's).  The epoch tile kernel with one
   base and with two: ptxas's report of both instantiations (no spill),
   two flagship calls of each bit-identical, each map call's device
   operations against those of the per-tile partials and folds it
   replaced (one for a single-base map), and the SASS instructions of
   burst_chi per cell.  The
   emergent tile kernel at 1, 5, 16 and 64 channels, with ptxas's report
   (no spill) and the MUFU of its per-cell loop.  The RRL
   kernels are timed at 16 and 1000 channels: the tile kernel as the maps
   call beside the fold it replaced, the full-grid kernel on the
   flagship's factors and on the jet-free grid; ptxas's registers and
   spills of both are printed (no spill allowed).  The full-grid epoch and
   emergent kernels are timed on the flagship's cubes, on the jet-free
   grid (their main path's case), on a wholly jet cube (epoch) and at 64
   channels (emergent), with the epoch kernel's two bounds (both cubes
   whole; launch times only where base != 0) and ptxas's report of both
   (no spill allowed).  The Faddeeva kernel at the RRL fit's shape
   (1,062,496 float64 elements over that fit's range of x and y): ptxas's
   report (no spill), against its plain version (1e-13 of |w|), one
   launch a call, its device time beside the plain version's and their
   device operations a call, and its bound (the larger of bytes and
   float64 operations over 34 TFLOP/s).  The Hogbom kernels at the
   observed cube's block (as many 500^2 float64 channels as
   ``clean_cube`` puts in one, its CLEAN box, 250 iterations on every
   channel): ptxas's report (no spill), bit for bit their plain version
   on the same card tensors, two launches an iteration and one to
   finish, an iteration's device time beside the plain loop's, and its
   bound by bytes.

The line before the last is a JSON object with one entry per kernel, the
line-cube observation's numbers, phase 2g's times, phase 2h's numbers
(``cli``), phase 2i's (``fit``), phase 2j's (``parallel``) and phase
2k's (``examples``); the last
line is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --time-paths DIR

times the flagship's three calls with the package of the checkout DIR
(:func:`time_paths`), to compare two commits on one card.  Needs the repository
checkout beside this file and a CUDA device: without either it exits
non-zero and prints no result.
"""
import contextlib
import copy
import json
import os
import runpy
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
YEAR = 31536000.0
N_GRID = 512
FREQS = np.geomspace(3e8, 3e11, 16)
EPOCHS_YR = (2.0, 2.1, 2.2)
RRL_LINE = 'H58a'
RRL_NCHAN = 1000          # the bundled pipeline's H58a run: 1e8 Hz / 1e5 Hz
RRL_EPOCH_YR = 2.0
KERNEL_RTOL = 1e-5
MAP_RTOL = 2e-4
RRL_F32_RTOL = 1e-3
PIPELINE_RTOL = 1e-6      # a FITS product against the direct call
# H100 SXM data sheet: HBM bandwidth and float32 (non-tensor) peak
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# float32 operations per cell and channel of the RRL kernels, the work of
# the function (a division or an expm1f counts as one, a multiply-add as
# two): offset, stimulated factor, branch test and accumulation; then the
# Weideman-16 core (16 Goertzel steps of 4) or the asymptotic wings
RRL_OPS_COMMON, RRL_OPS_CORE, RRL_OPS_FAR = 10, 98, 33
# float32 instructions that csrc/rrl_maps.cu issues for the same parts,
# counted from the source with multiply-adds contracted (an FMA or a
# reciprocal counts as one), f + nu0 formed per channel, the Goertzel
# recurrence started at its second step and the stimulated factor by its
# 4-term series (every flagship jet cell); the card issues at most
# 33.5e12 of them per second (half the FLOP rate)
RRL_ISSUE_COMMON, RRL_ISSUE_CORE, RRL_ISSUE_FAR = 12, 52, 25
PEAK_F32_ISSUE_PER_S = PEAK_F32_OPS_PER_S / 2
# the Faddeeva kernel (csrc/voigt.cu) at the RRL fit cell's shape: the
# shipped jet's 1,062,496 cells in float64, x and y over what that fit's
# 17 channels hand it (|x| <= 11.1, 0.0105 <= y <= 72); its tolerance
# (of |w|, each element) in float64 and float32
WOFZ_N = 1_062_496
WOFZ_X, WOFZ_Y = 11.1, (0.0105, 72.0)
WOFZ_RTOL = {'float64': 1e-13, 'float32': 1e-5}
# float64 operations per element, counted from csrc/voigt.cu (a division,
# a negation or an exp counts as one): the interior (127 Horner steps of
# 7), the 15-level wings, and the y < 3e-5 Taylor terms on top of the
# interior's; the H100 SXM data sheet's float64 peak outside the tensor
# cores
WOFZ_OPS_INTERIOR, WOFZ_OPS_FAR, WOFZ_OPS_TAYLOR = 925, 145, 42
PEAK_F64_OPS_PER_S = 34e12
EMERGENT_EPOCH_YR = 2.2
EMERGENT_F32_RTOL = 3e-3
# float32 operations of the emergent kernels, counted from
# csrc/emergent_maps.cu (a division or a transcendental counts as one):
# per cell and channel of the ordered update; per burst of chi; per live
# tile cell outside the burst loop (unpacking, side test, a*chi^2, skip
# test); per cell of the scan op
EMERGENT_OPS_CHAN, EMERGENT_OPS_BURST, EMERGENT_OPS_CHI = 13, 8, 7
SCAN_OPS = 9
EPOCH_SRC = 'rajepy_tpu_torch/csrc/epoch_maps.cu'
RRL_SRC = 'rajepy_tpu_torch/csrc/rrl_maps.cu'
EMERGENT_SRC = 'rajepy_tpu_torch/csrc/emergent_maps.cu'
VOIGT_SRC = 'rajepy_tpu_torch/csrc/voigt.cu'
HOGBOM_SRC = 'rajepy_tpu_torch/csrc/hogbom.cu'
KERNELS = {   # name -> (source, TPU kernel replaced)
    'epoch_base_map_tiles': (EPOCH_SRC,
                             'rajepy_tpu/ops/pallas_kernels.py:348'),
    'epoch_base_maps2_tiles': (EPOCH_SRC,
                               'rajepy_tpu/ops/pallas_kernels.py:414'),
    'epoch_base_map_full': (EPOCH_SRC,
                            'rajepy_tpu/ops/pallas_kernels.py:203'),
    'rrl_tiles_pallas': (RRL_SRC, 'rajepy_tpu/ops/pallas_kernels.py:942'),
    'rrl_cube_pallas': (RRL_SRC, 'rajepy_tpu/ops/pallas_kernels.py:993'),
    'emergent_ff_tiles': (EMERGENT_SRC,
                          'rajepy_tpu/ops/pallas_kernels.py:707'),
    'emergent_ff_pallas': (EMERGENT_SRC,
                           'rajepy_tpu/ops/pallas_kernels.py:553'),
    'transfer_scan_pallas': (EMERGENT_SRC,
                             'rajepy_tpu/ops/pallas_kernels.py:104'),
    'wofz': (VOIGT_SRC, None),      # no TPU kernel: XLA fuses voigt.wofz
    'hogbom': (HOGBOM_SRC, None),   # no TPU kernel: a lax.while_loop
}
CONTINUUM_KERNELS = ('epoch_base_map_tiles', 'epoch_base_maps2_tiles',
                     'epoch_base_map_full')
RRL_KERNELS = ('rrl_tiles_pallas', 'rrl_cube_pallas')
EMERGENT_KERNELS = ('emergent_ff_tiles', 'emergent_ff_pallas',
                    'transfer_scan_pallas')
PIPELINE_KERNELS = ('epoch_base_maps2_tiles', 'rrl_tiles_pallas')
# Pipeline.execute's stages, as utils.profiling records them
STAGE_COMPUTE = 'rt stage: device compute'
STAGE_COPY = 'rt stage: product transfer'
STAGE_COPY_WRITE = 'rt stage: product transfer + FITS write'
STAGE_CKPT = 'checkpoint write'
# the synthetic observation's stages (phase 2e), as utils.profiling records
# them; the imaging stage's name ends with the image size
SYNTHOBS_STAGES = ('synthobs: uv tracks', 'synthobs: vis sampling (+noise)',
                   'synthobs: vis npz write', 'synthobs: mfs imaging',
                   'synthobs: image FITS write', 'host source fit (imfit)')
SYNTHOBS_RTOL = 1e-10     # the card against the CPU, float64 throughout
SYNTHOBS_NOISE_RTOL = 0.01
SYNTHOBS_IMSIZE = 500
# the line-cube observation's stages (phase 2f); the cube imaging stage's
# name ends with its channels and image size, and holds the prep, CLEAN
# and restore stages that clean_cube records inside it
CUBE_STAGES = ('synthobs: uv tracks', 'synthobs: vis sampling (+noise)',
               'synthobs: vis npz write', 'synthobs: cube imaging',
               'synthobs: cube prep', 'synthobs: cube CLEAN',
               'synthobs: cube restore', 'synthobs: image FITS write')
CUBE_CHECK_NCHAN = 8      # channels around nu0 held card against CPU
CUBE_CHECK_BLOCK = 3      # a second channel block for the same channels
# phase 3's Hogbom block: the observed cube's CLEAN box (half-size in
# pixels) on SYNTHOBS_IMSIZE^2 float64 planes, as many channels as
# clean_cube puts in a block, every channel to HOGBOM_NITER iterations
HOGBOM_BOX = 85
HOGBOM_NITER = 250


# phase 2g: the light curve's epochs [yr], 0 to 5 yr across the example
# jet's four bursts; the CPU model the card's reductions are held against
# (a float32 512^3 CPU model is too slow for the script); their tolerance
# (float32, relative to the largest magnitude: the last bits of the two
# devices' fills, and conservation_profiles' index_add_ uses atomics on a
# card)
ANALYSIS_EPOCHS_YR = np.linspace(0.0, 5.0, 50)
ANALYSIS_CPU_GRID = 128
ANALYSIS_RTOL = 1e-5
# the figures of Pipeline.execute(plot=True) that phase 2e checks, besides
# each epoch's ModelPlot.pdf
PIPELINE_FIGURES = ('GridPlot.pdf', 'JMLPlot.pdf')
# phase 2h: params['synthobs'] of the CLI's pipeline file, the block that
# the bundled example-pipeline-params.py documents, with UVFITS export
CLI_SYNTHOBS = {'thermalnoise': 'tsys-atm', 'user_pwv': 2.0,
                'weighting': 'briggs', 'robust': 0.5, 'niter': 500,
                'corruption': {'phase_rms_deg': 30., 'coherence_s': 600.},
                'selfcal': 'phase', 'selfcal_solint_s': 300.,
                'selfcal_rounds': 2, 'export_uvfits': True}
# the stages a run of the CLI adds to phase 2e's, by their names' starts
CLI_STAGES = ('synthobs: gain corruption', 'synthobs: selfcal round 1 ',
              'synthobs: selfcal round 2 ', 'synthobs: uvfits_clean write',
              'synthobs: uvfits_noisy write', 'synthobs: selfcal npz write',
              'synthobs: vis npz write', 'host source fit (imfit)')
CLI_IMAGING = ('', ', selfcal 1', ', selfcal 2')   # mfs imaging labels
CLI_PRODUCTS = ('ms_clean', 'ms_noisy', 'ms_selfcal', 'gains',
                'uvfits_clean', 'uvfits_noisy', 'clean_image', 'estimates',
                'imfit')
CLI_DFT_PIX = 64          # the cut-out around the source the DFTs take
CLI_DFT_NVIS = 4096
# phase 2i: the fits.  The free parameters and the start (mlr_bj x 1.3,
# T_0 x 0.7 of the truth); Adam's steps of the SED and light-curve fits
# and of the RRL and visibility fits; the float32 step-0 gradient against
# float64 on the card; the float64 card-vs-CPU grid and tolerance; the RRL
# fit's channels across the line (nu0 (1 +- 4e-4)); the sweep's factors
FIT_FREE = ('properties.mlr_bj', 'properties.T_0')
FIT_START = {'mlr_bj': 1.3, 'T_0': 0.7}
FIT_STEPS, FIT_SHORT_STEPS = 20, 3
FIT_GRAD_RTOL = 1e-3
FIT_CPU_GRID, FIT_CPU_RTOL = 64, 1e-10
FIT_RRL_NCHAN = 9
FIT_SWEEP = {'mlr_bj': (0.5, 1.0, 2.0, 4.0), 'T_0': (1.0, 1.25)}
# the Laplace sigmas from a tensor on the card against those from numpy;
# closure_uncertainties on the first integrations of run 1's tracks,
# float64 at FIT_CPU_GRID^3, card against CPU
FIT_SAME_RTOL = 1e-12
FIT_CLOSURE_NT, FIT_CLOSURE_RTOL = 64, 1e-8
# phase 2j: shards on the one card; the sharded LOS sums against the
# single-device ones (the float32 order of the sum), and the sharded scan
# against the whole cube's (2e-4, as phase 2c's two scans); the kernels the
# parallel paths launch
PARALLEL_SHARDS = 4
PARALLEL_RTOL, PARALLEL_SCAN_RTOL = 1e-5, 2e-4
PARALLEL_KERNELS = ('epoch_base_map_tiles', 'epoch_base_maps2_tiles',
                    'rrl_tiles_pallas', 'rrl_cube_pallas',
                    'transfer_scan_pallas')
# phase 2k: the examples, in the order they run, each with the kernels it
# must launch; the noise-free fits' recovery of the truths they print; the
# production SED against flux_ff's sums of the same model; the w-stacked
# error's limit (of the total flux); the example run by ``python -m``
K1K4 = ('epoch_base_map_tiles', 'rrl_tiles_pallas')
EXAMPLE_KERNELS = {
    'single_chip_production': K1K4,
    'multi_chip_sharded': ('epoch_base_map_tiles', 'epoch_base_maps2_tiles'),
    'nonlte_and_surveys': K1K4,
    'fit_parameters': K1K4,            # its observations, not its fits
    'calibration_workflow': ('epoch_base_maps2_tiles',),
    'uvfits_interchange': ('epoch_base_maps2_tiles',),
    'wide_field_vlbi': ('epoch_base_map_tiles',),
}
# the cuts of step counts that keep phase 2k near its budget, against the
# defaults (the JAX examples': fit_parameters' 500 SED steps, 2,000 MALA
# steps of which 400 burn-in, 800 light-curve and 700 RRL steps;
# wide_field_vlbi's 150): phase 2k prints each fit's time per step on the
# card, and its recovery checks (2%) hold at these counts (on an NVIDIA
# H100: the RRL fit's v_lsr, the slowest, 0.96% off at 200 steps and
# 0.45% at 220; SED and light curve <= 0.62% at 100; wide-field mlr_bj
# 1.8e-4 at 100 and at 150)
EXAMPLE_KWARGS = {'fit_parameters': dict(sed_steps=100, mala_steps=100,
                                         mala_burn=20, lc_steps=100,
                                         rrl_steps=200),
                  'wide_field_vlbi': dict(steps=100)}
# the fit entry points the examples call, each timed in its example's run
EXAMPLE_FITS = ('fit_sed', 'sample_posterior', 'fit_light_curve',
                'fit_rrl_spectrum', 'fit_closures', 'fit_uvfits',
                'fit_visibilities')
# the kernel wrappers the small examples launch, each with its plain
# version: every example but the 512^3 one (held at its own shapes) holds
# each kernel's first launch against it
# (wrapper: its launch count's name, its plain version)
EXAMPLE_PLAIN = {
    'epoch_base_map_tiles': ('epoch_base_map_tiles',
                             'epoch_base_map_tiles_plain'),
    'epoch_base_maps2_tiles': ('epoch_base_maps2_tiles',
                               'epoch_base_maps2_tiles_plain'),
    'rrl_tiles': ('rrl_tiles_pallas', 'rrl_tiles_plain')}
# nonlte_and_surveys' float32 line-centre fluxes on the card against
# float64 on the card: the LTE and non-LTE fluxes and their ratio with
# scalar departure coefficients, and the flux with per-sightline maps
# (whose float32 b_n2 - b_n1 carries ~5e-3 of its ~1e-5)
NONLTE_F32_RTOL, NONLTE_MAPS_RTOL = 1e-5, 1e-3
EXAMPLE_FIT_RTOL = 0.02
EXAMPLE_SED_RTOL = 1e-6
EXAMPLE_WSTACK_MAX = 1e-3
EXAMPLE_SUBPROCESS = 'nonlte_and_surveys'


def rel_err(got, want):
    """(max |got - want| / max |want|, max |got - want|) over tensors."""
    got = got.double()
    want = want.double()
    abs_err = float((got - want).abs().max()) if want.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    return (abs_err / scale if scale > 0 else abs_err), abs_err


def check(name, got, want, rtol):
    rel, abs_err = rel_err(got, want)
    print(f"  {name}: max rel err {rel:.3e}, max abs err {abs_err:.3e} "
          f"(tolerance {rtol:g})")
    if not rel <= rtol:
        raise AssertionError(f"{name}: rel err {rel:.3e} > {rtol:g}")
    return rel, abs_err


def check_host(name, got, want, rtol):
    """:func:`check` of host arrays that hold NaN outside the jet: the same
    cells must be NaN in both."""
    import torch
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    if got.shape != want.shape or \
            not np.array_equal(np.isnan(got), np.isnan(want)):
        raise AssertionError(f"{name}: shapes {got.shape}, {want.shape} or "
                             f"NaN cells differ")
    return check(name, torch.from_numpy(np.nan_to_num(got)),
                 torch.from_numpy(np.nan_to_num(want)), rtol)


def cuda_ms(fn, n_rep=30, batch=1, n_warm=3):
    """Median milliseconds per call of ``fn``: ``n_rep`` samples, each a
    run of ``batch`` back-to-back calls bracketed by CUDA events.  A batch
    keeps the card's queue full, so a short kernel is timed on the device
    rather than by the host's launch gap."""
    import torch
    for _ in range(n_warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n_rep):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def timed_once(fn):
    """(result, milliseconds) of one call of ``fn`` by CUDA events."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def device_busy(fn, n=10, n_top=8):
    """Per-call device busy time and wall time (ms) of ``n`` warm calls of
    ``fn`` under ``torch.profiler``, device operations per call, and the
    busiest kernels as (name, launches per call, ms per call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            calls, us = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    busy_ms = sum(us for _, us in kernels.values()) / 1e3 / n
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:n_top]
    n_ops = sum(c for c, _ in kernels.values()) / n
    return busy_ms, wall_ms, n_ops, [(k, c // n, us / 1e3 / n)
                                     for k, (c, us) in top]


def kernel_ms(fn, n=10):
    """Device time per call (ms) of the kernels that ``fn`` launches once
    each, by ``torch.profiler`` over ``n`` warm calls: the sum over kernel
    names of each one's mean duration, so the kernels' own time, free of
    the host's launch gap that a short call's CUDA events include, and of
    any event the profiler drops."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # a session now and then records no device event at all (seen after
    # many sessions in one process): take another, then time by CUDA events
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                calls, us = kernels.get(e.name, (0, 0.0))
                kernels[e.name] = (calls + 1, us + e.time_range.elapsed_us())
        if kernels:
            return sum(us / calls for calls, us in kernels.values()) / 1e3
    ms = cuda_ms(fn, batch=20)
    print(f"  (the profiler recorded no device time in three sessions: "
          f"{ms:.4f} ms by CUDA events, median of 30 batches of 20)")
    return ms


def print_busy(label, fn, n):
    busy_ms, wall_ms, n_ops, top = device_busy(fn, n=n)
    print(f"  torch.profiler, {n} warm {label}: device busy {busy_ms:.4f} ms "
          f"of {wall_ms:.4f} ms per call (idle share "
          f"{1.0 - busy_ms / wall_ms:.3f}), {n_ops:g} device operations per "
          f"call; busiest kernels per call:")
    for kname, n_calls, ms in top:
        print(f"    {ms:.4f} ms  {n_calls:3d}x  {kname[:90]}")


def bound(n_bytes, n_ops):
    """(ms, 'bytes' or 'operations'): the least time for the work."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def rrl_bytes(args, out_shape):
    """Bytes the RRL kernels must move for these inputs: the channel
    offsets and amp once, the other four factors only where amp != 0
    (elsewhere the contribution is 0 whatever they hold), the maps once."""
    import torch
    freqs_off, amp = args[0], args[1]
    n_live = int(torch.count_nonzero(amp))
    return (nbytes(freqs_off, amp) + 4 * 4 * n_live +
            4 * int(np.prod(out_shape)))


def rrl_ops(freqs_off, amp, rest, scale, yv, chunk=32):
    """Float32 operations the RRL kernels need for these inputs: every
    jet cell (amp != 0) and channel pays the common part plus the core or
    the wings, as |x| + y falls (other cells contribute exactly 0)."""
    import torch
    live = amp != 0
    r, s, y = rest[live], scale[live], yv[live]
    n_far = 0
    for c0 in range(0, freqs_off.numel(), chunk):
        x = (freqs_off[c0:c0 + chunk, None] - r[None]) * s[None]
        n_far += int(torch.count_nonzero(x.abs() + y[None] > 8.0))
    n_pairs = int(r.numel()) * int(freqs_off.numel())
    n_core = n_pairs - n_far
    return (n_pairs * RRL_OPS_COMMON + n_core * RRL_OPS_CORE +
            n_far * RRL_OPS_FAR), n_core, n_far


def print_ptxas(log, pattern, want):
    """ptxas's registers, shared memory and spills of the kernels whose
    name matches ``pattern`` (every instance a kernel is built in), from
    the build's report; raises if one spills or the kernels found are not
    ``want``."""
    import re
    found = set()
    for entry in log.split("Compiling entry function '")[1:]:
        name = entry.split("'", 1)[0]
        kernel = re.search(pattern, name)
        if kernel is None:
            continue
        found.add(kernel.group(0))
        used = re.search(r'Used \d+ registers[^\n]*', entry)
        spill = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill '
                          r'loads', entry)
        print(f"  ptxas {name}: {used.group(0) if used else '?'}; "
              f"{spill.group(0) if spill else '?'}")
        if spill is None or int(spill.group(1)) or int(spill.group(2)):
            raise AssertionError(f"{name}: spills, or no ptxas report")
    if found != want:
        raise AssertionError(f"ptxas reported the kernels {found}, not "
                             f"{want}")


def sass_functions(lib_path):
    """{mangled kernel name: [(address, instruction)]} of a shared library,
    from ``cuobjdump -sass`` (NOPs left out)."""
    import re
    import shutil
    tool = shutil.which('cuobjdump') or os.path.join(
        os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'cuobjdump')
    text = subprocess.run([tool, '-sass', lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r'\s*Function : (\S+)', line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r'\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;', line)
        if m and cur is not None and not m.group(2).startswith('NOP'):
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def sass_opcode(ins):
    """The opcode of one SASS instruction, its predicate left out."""
    words = ins.split()
    return words[1] if words[0].startswith('@') else words[0]


def sass_loops(code):
    """The loops of one kernel's SASS, innermost first: (first address,
    last address, instructions, MUFU instructions) of every backward
    branch's range."""
    import re
    loops = []
    for addr, ins in code:
        m = re.search(r'\bBRA\b.*?0x([0-9a-f]+)', ins)
        if m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            body = [i for a, i in code if lo <= a <= addr]
            loops.append((lo, addr, len(body),
                          sum(sass_opcode(i).startswith('MUFU')
                              for i in body)))
    return sorted(loops, key=lambda lp: lp[1] - lp[0])


def sass_kernel(funcs, fragment):
    """The SASS of the one kernel whose mangled name holds ``fragment``."""
    found = [k for k in funcs if fragment in k]
    if len(found) != 1:
        raise AssertionError(f"SASS: kernels matching {fragment}: {found}")
    return funcs[found[0]]


def chi_instructions(funcs, bursts):
    """Instructions that burst_chi issues per cell, from the SASS of
    burst_chi_probe_kernel (chi alone, one cell a thread): those between
    the probe's load of the launch time and its store of chi, the burst
    loop's body counted once per burst of the cell's side.  Returns
    (fixed, loop body, {side: per cell})."""
    code = sass_kernel(funcs, 'burst_chi_probe_kernel')
    ops = [sass_opcode(i) for _, i in code]
    lo = next(k for k, op in enumerate(ops) if op.startswith('LDG'))
    hi = next(k for k, op in enumerate(ops) if op.startswith('STG'))
    loops = sass_loops(code)
    if len(loops) != 1:
        raise AssertionError(f"burst_chi_probe_kernel: {len(loops)} loops")
    body = loops[0][2]
    fixed = hi - lo - 1 - body
    n_red = sum(1 for b in bursts if b[3])
    sides = {'red': n_red, 'blue': len(bursts) - n_red}
    return fixed, body, {k: fixed + n * body for k, n in sides.items()}


def example_params(n=None, csize=None):
    p = runpy.run_path(os.path.join(HERE, 'rajepy_tpu_torch', 'data',
                                    'example-model-params.py'))['params']
    p = copy.deepcopy(p)
    if n is not None:
        p['grid'].update(n_x=n[0], n_y=n[1], n_z=n[2], l_z=None)
    if csize is not None:
        p['grid']['c_size'] = csize
    return p


def random_tiles(rng, n_act, device):
    """Compacted tiles with empty tiles and negative travel times."""
    import torch
    from rajepy_tpu_torch.ops import kernels as kn
    shape = (n_act,) + kn.TILE
    base = rng.random(shape)
    base[::3] = 0.0                               # fully empty tiles
    ts = rng.uniform(-0.05 * YEAR, 2.5 * YEAR, shape)
    ts[1] = rng.uniform(-0.05 * YEAR, 0.0, shape[1:])   # all negative
    red = rng.random(shape) < 0.5
    off = kn.pack_offset_for(ts.min())
    tss = np.where(red, -(ts + off), ts + off)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return as_t(base), as_t(rng.random(shape)), as_t(tss), off


def rrl_factors(rng, shape, device):
    """Random RRL kernel factors (amp, rest, scale, y_voigt, hkT), with
    |rest| <= 1e5 Hz, 1/scale in [2e5, 8e5] Hz and y_voigt in [0, 3]."""
    import torch
    amp = rng.random(shape) * 1e-3
    amp[rng.random(shape) < 0.3] = 0.0
    out = [amp, rng.uniform(-1e5, 1e5, shape),
           1.0 / rng.uniform(2e5, 8e5, shape), rng.uniform(0.0, 3.0, shape),
           4.8e-11 / rng.uniform(5e3, 2e4, shape)]
    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in out]


def chan_consts(freqs, device):
    """(cnu, hnuk) = (2 h nu^3 / c^2, h nu / k) in float64, cast to
    float32, as the model forms them."""
    import torch
    from rajepy_tpu_torch import constants as cnsts
    f64 = np.asarray(freqs, dtype=np.float64)
    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in (2.0 * cnsts.H_CGS * f64 ** 3 / cnsts.C_CGS ** 2,
                      cnsts.H_CGS * f64 / cnsts.K_CGS)]


def emergent_oracle(cnu, hnuk, temp, dtau, near_y0=False):
    """float64 host oracle of the ordered emergent scan (bench.py's): the
    given (n_chan, nx, ny, nz) opacity, the exact blackbody source where
    the opacity is non-zero, tau in front of each cell by cumsum."""
    d = np.asarray(dtau.double().cpu(), np.float64)
    t64 = np.asarray(temp.double().cpu(), np.float64)[None]
    cn = np.asarray(cnu.double().cpu())[:, None, None, None]
    hk = np.asarray(hnuk.double().cpu())[:, None, None, None]
    with np.errstate(over='ignore'):
        src = np.where(d > 0, cn / np.expm1(hk / t64), 0.0)
    if not near_y0:
        d, src = d[:, :, ::-1], src[:, :, ::-1]
    tau_in = np.cumsum(d, axis=2) - d
    return np.sum(src * np.exp(-tau_in) * (-np.expm1(-d)), axis=2)


def emergent_tiles_oracle(cnu, hnuk, scale, temp_t, a_t, tss_t, starts, t,
                          bursts, off):
    """float64 oracle of the emergent tile kernel: chi from the packed
    launch times, each segment's tiles joined along y in observer order."""
    import torch
    tss = np.asarray(tss_t.double().cpu())
    lt = t - (np.abs(tss) - off)
    red = tss < 0.0
    chi = np.ones_like(lt)
    for t0, inv2s2, amp, is_red in bursts:
        g = amp * np.exp(-(lt - t0) ** 2 * inv2s2)
        chi += np.where(red if is_red else ~red, g, 0.0)
    d_base = np.asarray(a_t.double().cpu()) * chi * chi
    sc = np.asarray(scale.double().cpu())[:, None, None, None]
    out = []
    for s0, s1 in zip(starts[:-1], starts[1:]):
        d = sc * np.concatenate(list(d_base[s0:s1]), axis=1)[None]
        temp = torch.as_tensor(np.concatenate(
            list(np.asarray(temp_t[s0:s1].double().cpu())), axis=1))
        out.append(emergent_oracle(cnu, hnuk, temp, torch.as_tensor(d),
                                   near_y0=True))
    return np.stack(out)


def check_emergent_kernels(bursts, dev):
    """Phase 1 for the emergent kernels: each against its plain version on
    small card tensors, and the tile and full-grid kernels against the
    float64 oracle."""
    import torch
    from rajepy_tpu_torch.ops import kernels as kn
    from rajepy_tpu_torch.ops import radtrans as rt
    rng = np.random.default_rng(3)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    t = 2.0 * YEAR
    # tiles: 4 segments of 2, 1, 3 and 1 tiles in observer order; tiles 0,
    # 3 and 6 fully empty (so is the one-tile segment 3); 6 channels
    a_t, _, tss_t, off = random_tiles(rng, 7, dev)
    a_t = a_t * as_t(rng.random(a_t.shape) < 0.4)
    temp_t = torch.where(a_t > 0, as_t(rng.uniform(5e3, 2e4, a_t.shape)),
                         torch.ones_like(a_t))
    seg = np.array([0, 0, 1, 2, 2, 2, 3])
    starts = kn.segment_starts(seg, 4)
    seg_start = torch.as_tensor(starts, device=dev)
    freqs = np.geomspace(1e9, 3e11, 6)
    cnu, hnuk = chan_consts(freqs, dev)
    scale = as_t(np.geomspace(1e-3, 0.3, 6))
    args = (cnu, hnuk, scale, temp_t, a_t, tss_t, seg_start, t, bursts, off)
    got = kn.emergent_tile_partials(*args)
    want = kn.emergent_tile_partials_plain(*args)
    check('emergent_ff_tiles I', got[0], want[0], KERNEL_RTOL)
    check('emergent_ff_tiles tau', got[1], want[1], KERNEL_RTOL)
    if got[0][3].abs().max() != 0 or got[1][3].abs().max() != 0:
        raise AssertionError("an empty segment gave non-zero maps")
    oracle = emergent_tiles_oracle(cnu, hnuk, scale, temp_t, a_t, tss_t,
                                   starts, t, bursts, off)
    check('emergent_ff_tiles vs float64 oracle', got[0],
          torch.as_tensor(oracle, device=dev), KERNEL_RTOL)
    # every block shape of the kernel (channel groups x chunks: 1 x 16 ..
    # 16 x 1, and two channel blocks at 70), tau from ~1e-3 to the
    # thousands
    for n_chan in (1, 5, 16, 64, 70):
        cnu, hnuk = chan_consts(np.geomspace(3e8, 3e11, n_chan), dev)
        scale = as_t(np.geomspace(3e2, 1e-3, n_chan))
        args = (cnu, hnuk, scale, temp_t, a_t, tss_t, seg_start, t, bursts,
                off)
        got = kn.emergent_tile_partials(*args)
        want = kn.emergent_tile_partials_plain(*args)
        check(f'emergent_ff_tiles I, {n_chan} ch', got[0], want[0],
              KERNEL_RTOL)
        check(f'emergent_ff_tiles tau, {n_chan} ch (max '
              f'{float(want[1].max()):.4g})', got[1], want[1], KERNEL_RTOL)
        if n_chan == 16:
            oracle = emergent_tiles_oracle(cnu, hnuk, scale, temp_t, a_t,
                                           tss_t, starts, t, bursts, off)
            check('emergent_ff_tiles vs float64 oracle, 16 ch', got[0],
                  torch.as_tensor(oracle, device=dev), KERNEL_RTOL)

    # full grid and scan op: ragged in every axis, an empty x slab and a
    # zero-opacity y range; 20 channels (two channel blocks of 16)
    shape = (37, 70, 150)
    inside = rng.random(shape) < 0.3
    inside[:8] = False
    inside[:, 20:45] = False
    temp = as_t(np.where(inside, rng.uniform(5e3, 2e4, shape), 1.0))
    base = as_t(np.where(inside, 0.05 * rng.random(shape), 0.0))
    freqs = np.geomspace(1e9, 3e11, 20)
    cnu, hnuk = chan_consts(freqs, dev)
    scale = as_t(np.geomspace(0.02, 5.0, 20))
    src = as_t(rng.random(shape))
    for near in (False, True):
        got = kn.emergent_ff_full(cnu, hnuk, scale, temp, base, near)
        want = kn.emergent_ff_full_plain(cnu, hnuk, scale, temp, base, near)
        check(f'emergent_ff_pallas I, near_y0={near}', got[0], want[0],
              KERNEL_RTOL)
        check(f'emergent_ff_pallas tau, near_y0={near}', got[1], want[1],
              KERNEL_RTOL)
        if got[0][:, :8].abs().max() != 0:
            raise AssertionError("the empty slab gave non-zero maps")
        got = kn.transfer_scan_maps(src, base * 3.0, near)
        want = kn.transfer_scan_maps_plain(src, base * 3.0, near)
        check(f'transfer_scan_pallas I, near_y0={near}', got[0], want[0],
              KERNEL_RTOL)
        check(f'transfer_scan_pallas tau, near_y0={near}', got[1], want[1],
              KERNEL_RTOL)
    # bench.py's case for the full-grid kernel against the oracle
    shape = (16, 48, 128)
    inside = rng.random(shape) < 0.3
    inside[8:] = False
    temp = as_t(np.where(inside, 1e4 * (0.5 + rng.random(shape)), 1.0))
    n_es = as_t(np.where(inside, 1e7 * rng.random(shape), 0.0))
    ds = as_t(np.where(inside, 7.5e12, 0.0))
    inside = torch.as_tensor(inside, device=dev)
    base = rt.tau_ff_base(temp, n_es, ds, inside, True)
    freqs = np.linspace(1e9, 5e10, 6)
    cnu, hnuk = chan_consts(freqs, dev)
    scale = rt.tau_ff_channel_scale(as_t(freqs), 1e4, True)
    got = kn.emergent_ff_full(cnu, hnuk, scale, temp, base)
    oracle = emergent_oracle(cnu, hnuk, temp,
                             scale[:, None, None, None] * base[None])
    check('emergent_ff_pallas vs float64 oracle', got[0],
          torch.as_tensor(oracle, device=dev), KERNEL_RTOL)


def full_grid_cubes(rng, dev):
    """Small cubes for the two full-grid kernels, as (label, base, tss,
    temp, pack offset): base >= 0 with zeros, packed launch times with
    negative travel times, temperature 1 where base is 0.  A grid with
    nz % 4 != 0 (4-byte copies throughout), a wholly jet cube, a cube
    whose only jet cells lie in the last y row and the last z column, an
    all-zero cube whose launch times are not finite, and a view one float
    off a 16-byte boundary."""
    import torch
    from rajepy_tpu_torch.ops import kernels as kn
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)

    def cube(shape, inside):
        ts = rng.uniform(-0.05 * YEAR, 2.5 * YEAR, shape)
        off = kn.pack_offset_for(ts.min())
        tss = np.where(rng.random(shape) < 0.5, -(ts + off), ts + off)
        base = np.where(inside, 0.05 * (0.1 + rng.random(shape)), 0.0)
        temp = np.where(inside, rng.uniform(5e3, 2e4, shape), 1.0)
        return as_t(base), as_t(tss), as_t(temp), off

    out = []
    shape = (10, 70, 130)
    out.append(('nz % 4 != 0', *cube(shape, rng.random(shape) < 0.3)))
    shape = (9, 150, 128)
    out.append(('wholly jet', *cube(shape, np.ones(shape, bool))))
    shape = (11, 133, 200)
    edge = np.zeros(shape, bool)
    edge[:, -1, :] = True
    edge[:, :, -1] = True
    out.append(('last y row and z column only', *cube(shape, edge)))
    shape = (6, 40, 64)
    base, tss, temp, off = cube(shape, np.zeros(shape, bool))
    tss[::2] = float('nan')
    tss[1::2] = float('inf')
    out.append(('all zero, launch times not finite', base, tss, temp, off))
    shape = (8, 64, 128)
    base, tss, temp, off = cube(shape, rng.random(shape) < 0.3)
    n = base.numel()
    shifted = []
    for c in (base, tss, temp):
        buf = torch.empty(n + 1, dtype=torch.float32, device=dev)
        buf[1:] = c.reshape(-1)
        shifted.append(buf[1:].view(shape))
    if shifted[0].data_ptr() % 16 == 0 or not shifted[0].is_contiguous():
        raise AssertionError("the shifted view is aligned")
    out.append(('view off a 16-byte boundary', *shifted, off))
    return out


def check_full_grid_kernels(bursts, dev):
    """Phase 1 for the two kernels that stream base through the
    shared-memory ring, each against its plain version on the cubes of
    :func:`full_grid_cubes`; the emergent one at 1, 17 and 64 channels and
    both observer orientations."""
    import torch
    from rajepy_tpu_torch.ops import kernels as kn
    rng = np.random.default_rng(5)
    t = 2.0 * YEAR
    for label, base, tss, temp, off in full_grid_cubes(rng, dev):
        got = kn.epoch_base_map_full(base, tss, t, bursts, off)
        want = kn.epoch_base_map_full_plain(base, tss, t, bursts, off)
        check(f'epoch_base_map_full, {label} {tuple(base.shape)}', got, want,
              KERNEL_RTOL)
        maps = [got, want]
        worst = 0.0
        for n_chan in (1, 17, 64):
            freqs = np.geomspace(1e9, 3e11, n_chan)
            cnu, hnuk = chan_consts(freqs, dev)
            scale = torch.as_tensor(np.geomspace(0.02, 5.0, n_chan),
                                    dtype=torch.float32, device=dev)
            for near in (False, True):
                args = (cnu, hnuk, scale, temp, base, near)
                got = kn.emergent_ff_full(*args)
                want = kn.emergent_ff_full_plain(*args)
                worst = max([worst] + [rel_err(g, w)[0]
                                       for g, w in zip(got, want)])
                maps += [*got, *want]
        print(f"  emergent_ff_pallas I and tau, {label}, 1, 17 and 64 ch, "
              f"both near_y0: max rel err {worst:.3e} (tolerance "
              f"{KERNEL_RTOL:g})")
        if not worst <= KERNEL_RTOL:
            raise AssertionError(f"emergent_ff_pallas, {label}: rel err "
                                 f"{worst:.3e} > {KERNEL_RTOL:g}")
        if not bool(base.any()) and any(int(torch.count_nonzero(m))
                                        for m in maps):
            raise AssertionError(f"{label}: an all-zero base gave non-zero "
                                 f"or non-finite maps")


# channel offsets from nu0 [Hz] that put every cell of rrl_factors in the
# wings, every cell in the core, and a mix
RRL_CHANNEL_SETS = {'all-far': (1e7, 5e7, 9), 'all-near': (-2e5, 2e5, 7),
                    'mixed': (-4e6, 4e6, 21)}


def phase_kernels(bursts):
    """Each kernel against its plain version on small card tensors."""
    import torch
    from rajepy_tpu_torch.ops import kernels as kn
    dev = torch.device('cuda')
    print("phase 1: kernels against their plain versions (small shapes)")
    t0 = time.perf_counter()
    kn.build()
    print(f"  build {time.perf_counter() - t0:.1f} s ({len(kn.sources())} "
          f"sources, one nvcc each, in parallel)")
    log = kn.build_log()
    if log:
        print("  nvcc: " + log.strip().replace('\n', '\n  nvcc: '))
    rng = np.random.default_rng(1)
    t = 2.0 * YEAR
    n_act = 7
    a_t, b_t, tss_t, off = random_tiles(rng, n_act, dev)
    check_epoch_tile_maps(a_t, b_t, tss_t, bursts, off, dev)
    chi = kn.burst_chi_probe(tss_t, t, bursts, off)
    check('burst_chi (the kernels\' chi alone) vs its plain version', chi,
          kn._chi_plain(tss_t, t, bursts, off), KERNEL_RTOL)
    print(f"  burst_chi bit for bit equal to the plain version: "
          f"{bool(torch.equal(chi, kn._chi_plain(tss_t, t, bursts, off)))}")
    # full grid, ragged in every axis, an empty x slab, negative ts
    shape = (37, 70, 150)
    a = rng.random(shape)
    a[:8] = 0.0
    ts = rng.uniform(-0.05 * YEAR, 2.5 * YEAR, shape)
    red = rng.random(shape) < 0.5
    off = kn.pack_offset_for(ts.min())
    tss = np.where(red, -(ts + off), ts + off)
    a = torch.as_tensor(a, dtype=torch.float32, device=dev)
    tss = torch.as_tensor(tss, dtype=torch.float32, device=dev)
    got = kn.epoch_base_map_full(a, tss, t, bursts, off)
    want = kn.epoch_base_map_full_plain(a, tss, t, bursts, off)
    check('epoch_base_map_full', got, want, KERNEL_RTOL)

    check_rrl_kernels(rng, shape, dev)
    check_emergent_kernels(bursts, dev)
    check_full_grid_kernels(bursts, dev)
    check_wofz_kernel(dev)
    torch.cuda.synchronize()


def wofz_gap(got, want):
    """max over elements of |w_got - w_want| / |w_want| of two (re, im)
    pairs, and the share of elements equal bit for bit."""
    import torch
    g = torch.complex(got[0].double(), got[1].double())
    w = torch.complex(want[0].double(), want[1].double())
    same = (got[0] == want[0]) & (got[1] == want[1])
    return (float(((g - w).abs() / w.abs()).max()),
            float(same.double().mean()))


def check_wofz_kernel(dev):
    """The Faddeeva kernel against its plain version (``voigt._wofz_plain``
    on the same card tensors) in float64 and float32: across the interior,
    both sides of the wings' cut, y < 3e-5 and y = 0, |x| up to 1e4, and
    on expanded inputs."""
    import torch
    from rajepy_tpu_torch.ops import kernels as kn
    from rajepy_tpu_torch.ops import voigt
    for dtype, cut in (('float64', 9.0), ('float32', 8.0)):
        xs = np.concatenate([[0.0], np.logspace(-3, 4, 97),
                             cut + np.array([-1e-9, 0.0, 1e-9]),
                             np.linspace(0.5, cut + 1.0, 31)])
        ys = np.concatenate([[0.0, 1e-12, 2.9e-5, 3e-5, 3.1e-5, 0.5],
                             np.logspace(-4, 3, 30)])
        x, y = np.meshgrid(np.concatenate([xs, -xs]), ys)
        x, y = (torch.as_tensor(a.ravel(), dtype=getattr(torch, dtype),
                                device=dev) for a in (x, y))
        n = kn.LAUNCHES['wofz']
        got = voigt.wofz(x, y)
        rel, same = wofz_gap(got, voigt._wofz_plain(x, y))
        # expanded: a row of x against a column of y
        got_e = voigt.wofz(x[:200], y[::50, None])
        xe, ye = torch.broadcast_tensors(x[:200], y[::50, None])
        rel_e, same_e = wofz_gap(got_e, voigt._wofz_plain(xe, ye))
        print(f"  wofz ({dtype}, {x.numel()} elements; expanded "
              f"{tuple(xe.shape)}): max |dw|/|w| {rel:.3e}, "
              f"{rel_e:.3e} (tolerance {WOFZ_RTOL[dtype]:g}); bit for bit "
              f"equal {same:.4f}, {same_e:.4f} of the elements")
        if not max(rel, rel_e) <= WOFZ_RTOL[dtype]:
            raise AssertionError(f"wofz ({dtype}): {max(rel, rel_e):.3e}")
        if kn.LAUNCHES['wofz'] != n + 2:
            raise AssertionError(f"wofz: {kn.LAUNCHES['wofz'] - n} "
                                 f"launches for two calls")


def wofz_numbers(smi):
    """Phase 3 for the Faddeeva kernel at the RRL fit's shape (WOFZ_N
    float64 elements, seeded over the fit's range): ptxas's report (no
    spill), the kernel against its plain version, one launch a call, its
    device time beside the plain version's (with both calls' device
    operations) and its bound.  Returns the summary line's row and the
    (max relative, max absolute) error of w."""
    import torch
    from rajepy_tpu_torch.ops import kernels as kn
    from rajepy_tpu_torch.ops import voigt
    print_ptxas(kn.build_log(), r'wofz_f(64|32)_kernel',
                {'wofz_f64_kernel', 'wofz_f32_kernel'})
    rng = np.random.default_rng(21)
    x = torch.as_tensor(rng.uniform(-WOFZ_X, WOFZ_X, WOFZ_N), device='cuda')
    y = torch.as_tensor(np.exp(rng.uniform(*np.log(WOFZ_Y), WOFZ_N)),
                        device='cuda')
    n = kn.LAUNCHES['wofz']
    got = voigt.wofz(x, y)
    if kn.LAUNCHES['wofz'] != n + 1:
        raise AssertionError("wofz: not one launch a call")
    want = voigt._wofz_plain(x, y)
    rel, same = wofz_gap(got, want)
    abs_err = float(torch.complex(got[0] - want[0], got[1] - want[1])
                    .abs().max())
    print(f"  wofz (float64) at the RRL fit's shape, {WOFZ_N} elements: "
          f"max |dw|/|w| {rel:.3e} (tolerance {WOFZ_RTOL['float64']:g}), "
          f"max |dw| {abs_err:.3e}; bit for bit equal {same:.4f} of the "
          f"elements")
    if not rel <= WOFZ_RTOL['float64']:
        raise AssertionError(f"wofz at the fit's shape: {rel:.3e}")
    far = (x.abs() + y) > 9.0
    tiny = y < 3e-5
    n_far = int(far.sum())
    n_int = WOFZ_N - n_far
    n_ops = (n_int * WOFZ_OPS_INTERIOR + n_far * WOFZ_OPS_FAR +
             int((tiny & ~far).sum()) * WOFZ_OPS_TAYLOR)
    n_b = 4 * WOFZ_N * 8
    t_ops = n_ops / PEAK_F64_OPS_PER_S * 1e3
    t_bytes = n_b / PEAK_BYTES_PER_S * 1e3
    b_ms, b_by = max((t_ops, 'operations'), (t_bytes, 'bytes'))
    k_ev = cuda_ms(lambda: voigt.wofz(x, y), batch=10)
    dev = kernel_ms(lambda: kn.wofz_kernel(x, y))
    p_ms = cuda_ms(lambda: voigt._wofz_plain(x, y), n_rep=5, n_warm=1)
    print(f"  wofz kernel: device {dev:.4f} ms (profiler, mean of 10), "
          f"{k_ev:.4f} ms a voigt.wofz call (CUDA events, median of 30 "
          f"batches of 10); plain {p_ms:.4f} ms (median of 5); bound "
          f"{b_ms:.4f} ms by {b_by} ({n_ops} float64 ops: {n_int} "
          f"interior and {n_far} wing elements; {n_b} B), {b_ms / dev:.3f} "
          f"of it [{smi}]")
    print_busy('voigt.wofz calls (kernel)', lambda: voigt.wofz(x, y), 10)
    print_busy('plain calls', lambda: voigt._wofz_plain(x, y), 3)
    return ('wofz', dev, p_ms, b_ms, b_by), (rel, abs_err)


def hogbom_block(nb, n, box):
    """(nb, n, n) float64 dirty images and PSFs on the card and an (n, n)
    mask of half-size ``box`` about the centre: each PSF a Gaussian core
    of its own width with a negative shelf, each dirty image three
    PSF-shaped sources of seeded amplitude inside the mask plus noise."""
    import torch
    g = torch.Generator(device='cuda').manual_seed(25)
    dt = dict(dtype=torch.float64, device='cuda')
    yx = torch.arange(n, **dt)
    c0 = n // 2

    def shape(py, px, w):
        r2 = ((yx[None, :, None] - py[:, None, None]) ** 2 +
              (yx[None, None, :] - px[:, None, None]) ** 2)
        w2 = (w * w)[:, None, None]
        return torch.exp(-r2 / (2.0 * w2)) - 0.1 * torch.exp(-r2 / (18.0 *
                                                                      w2))

    w = 2.0 + 4.0 * torch.rand(nb, generator=g, **dt)
    centre = torch.full((nb,), float(c0), **dt)
    psf = shape(centre, centre, w) / 0.9
    dirty = 0.01 * torch.randn(nb, n, n, generator=g, **dt)
    for _ in range(3):
        py, px = (torch.randint(c0 - box, c0 + box, (nb,), generator=g,
                                device='cuda').double() for _ in range(2))
        amp = 0.5 + 2.5 * torch.rand(nb, generator=g, **dt)
        dirty += amp[:, None, None] * shape(py, px, w)
    mask = torch.zeros(n, n, **dt)
    mask[c0 - box:c0 + box, c0 - box:c0 + box] = 1.0
    return dirty, psf, mask


def hogbom_numbers(smi):
    """Phase 3 for the Hogbom kernels (W3) at the observed cube's block
    (as many 500^2 float64 channels as ``clean_cube`` puts in a block, its
    CLEAN box, every channel live for HOGBOM_NITER iterations): ptxas's
    report (no spill); ``imaging._hogbom`` on the card against its plain
    version ``_hogbom_plain`` on the same card tensors, models, residuals
    and counts equal under ``torch.equal``, in two launches an iteration
    and one to finish; both by the host clock; one iteration's device
    time and its bound (the residual read and written and the PSF read
    once over every plane).  Returns the summary line's row and the (max
    relative, max absolute) difference."""
    import torch
    from rajepy_tpu_torch.ops import kernels as kn
    from rajepy_tpu_torch.synthobs import imaging
    print_ptxas(kn.build_log(), r'hogbom_\w+?_kernel',
                {'hogbom_update_peak_kernel', 'hogbom_component_kernel'})
    n = SYNTHOBS_IMSIZE
    nb = imaging.CUBE_BLOCK_BYTES // (imaging.CUBE_PLANES * 8 * n * n)
    dirty, psf, mask = hogbom_block(nb, n, HOGBOM_BOX)
    thr = torch.zeros(nb, dtype=torch.float64)
    args = (dirty, psf, mask, thr, 0.1, HOGBOM_NITER)
    n0 = kn.LAUNCHES['hogbom']
    got, k_ms = timed_once(lambda: imaging._hogbom(*args))
    n_launch = kn.LAUNCHES['hogbom'] - n0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    want, p_ms = timed_once(lambda: imaging._hogbom_plain(*args))
    p_peak = torch.cuda.max_memory_allocated() - base
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    abs_err = max(float((a - b).abs().max()) for a, b in
                  zip(got[:2], want[:2]))
    rel = abs_err / float(dirty.abs().max())
    counts = set(got[2].tolist())
    print(f"  Hogbom, {nb} x {n}^2 float64, box half-size {HOGBOM_BOX}, "
          f"{HOGBOM_NITER} iterations: kernels {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms (one call each, CUDA events; the plain version "
          f"{p_peak / 1e9:.3f} GB above its inputs); {n_launch} launches; "
          f"iterations a channel {sorted(counts)}; equal under torch.equal "
          f"{same}, max |diff| {abs_err:.3e}")
    if not same or counts != {HOGBOM_NITER}:
        raise AssertionError("the Hogbom kernels are not their plain "
                             "version bit for bit, or a channel stopped")
    if n_launch != 2 * HOGBOM_NITER + 1:
        raise AssertionError(f"Hogbom: {n_launch} launches for "
                             f"{HOGBOM_NITER} iterations")
    del got, want
    cycle = kn.HogbomCycle(dirty, psf, mask, thr, 0.1)
    cycle.step()
    k_ev = cuda_ms(cycle.step, n_rep=30, batch=8, n_warm=2)
    dev = kernel_ms(cycle.step)
    n_b = 3 * nbytes(dirty)
    b_ms, b_by = bound(n_b, 0)
    print(f"  Hogbom iteration: device {dev:.4f} ms (profiler, mean of 10), "
          f"{k_ev:.4f} ms a step (CUDA events, median of 30 batches of 8); "
          f"plain {p_ms / HOGBOM_NITER:.4f} ms an iteration (the loop's "
          f"mean); bound {b_ms:.4f} ms by {b_by} ({n_b} B), "
          f"{b_ms / dev:.3f} of it [{smi}]")
    print_busy('Hogbom steps (kernels)', cycle.step, 10)
    return ('hogbom', dev, p_ms / HOGBOM_NITER, b_ms, b_by), (rel, abs_err)


# the epoch tile kernel's random-tile cases: (tile positions' segment ids,
# nx, nz): segments of 1 to 3 tiles out of segment order, positions with no
# tile, ragged x and z
EPOCH2_CASES = (([0, 0, 3, 1, 3, 2, 0], 16, 200),
                ([0, 0, 3, 1, 3, 2, 0], 24, 200),
                ([5, 5, 5, 0, 1, 2, 2], 21, 300))


def check_epoch_tile_maps(a_t, b_t, tss_t, bursts, off, dev):
    """Phase 1 for the epoch tile kernel with one base (K1) and with two
    (K2): the maps against their plain versions on :data:`EPOCH2_CASES`
    (the random tiles hold fully empty tiles and negative travel times),
    two calls bit-identical, exact zeros where no tile lies, K1's map of
    each base bit for bit K2's map of it, and the per-tile partials."""
    import torch
    from rajepy_tpu_torch.ops import kernels as kn
    t = 2.0 * YEAR
    for seg_l, nx, nz in EPOCH2_CASES:
        seg = torch.as_tensor(seg_l, dtype=torch.int64, device=dev)
        what = f'{nx}x{nz}, segments {seg_l}'
        got = kn.epoch_base_maps2_tiles(a_t, b_t, tss_t, seg, t, bursts, nx,
                                        nz, off)
        again = kn.epoch_base_maps2_tiles(a_t, b_t, tss_t, seg, t, bursts,
                                          nx, nz, off)
        want = kn.epoch_base_maps2_tiles_plain(a_t, b_t, tss_t, seg, t,
                                               bursts, nx, nz, off)
        for part, g, w in zip('ab', got, want):
            check(f'epoch_base_maps2_tiles ({part}), {what}', g, w,
                  KERNEL_RTOL)
        one = [kn.epoch_base_map_tiles(x, tss_t, seg, t, bursts, nx, nz, off)
               for x in (a_t, b_t)]
        one_again = kn.epoch_base_map_tiles(a_t, tss_t, seg, t, bursts, nx,
                                            nz, off)
        check(f'epoch_base_map_tiles, {what}', one[0],
              kn.epoch_base_map_tiles_plain(a_t, tss_t, seg, t, bursts, nx,
                                            nz, off), KERNEL_RTOL)
        if not (all(torch.equal(g, h) for g, h in zip(got, again)) and
                torch.equal(one[0], one_again)):
            raise AssertionError("two calls of an epoch tile kernel gave "
                                 "different bits")
        if not all(torch.equal(g, k1) for g, k1 in zip(got, one)):
            raise AssertionError("epoch_base_map_tiles of a base is not "
                                 "epoch_base_maps2_tiles' map of it bit for "
                                 "bit")
        n_zt = -(-nz // kn.TILE[2])
        for p in set(range(-(-nx // 8) * n_zt)) - set(seg_l):
            x0, z0 = (p // n_zt) * 8, (p % n_zt) * kn.TILE[2]
            if any(int(torch.count_nonzero(g[x0:x0 + 8, z0:z0 + 128]))
                   for g in (*got, *one)):
                raise AssertionError("a tile position with no tile gave "
                                     "non-zero maps")
    print("  epoch_base_map_tiles and epoch_base_maps2_tiles: two calls "
          "bit-identical, exact zeros where no tile lies, the one-base map "
          "of each base bit for bit the two-base kernel's")
    check('epoch_base_map_tiles per-tile partials',
          kn.epoch_tile_partials(a_t, tss_t, t, bursts, off),
          kn.epoch_tile_partials_plain(a_t, tss_t, t, bursts, off),
          KERNEL_RTOL)
    got = kn.epoch_tile_partials2(a_t, b_t, tss_t, t, bursts, off)
    want = kn.epoch_tile_partials2_plain(a_t, b_t, tss_t, t, bursts, off)
    for part, g, w in zip('ab', got, want):
        check(f'epoch_base_maps2_tiles per-tile partials ({part})', g, w,
              KERNEL_RTOL)


def check_rrl_kernels(rng, shape, dev):
    """Phase 1 for the RRL kernels, each against its plain version on
    small card tensors.  Tiles: 7 on a 3 x 2 grid of tile positions
    (24 x 200 maps), segments of 3, 2, 1 and 1 tiles out of segment order,
    two positions with no tile, tile 2 empty and tile 4 wholly jet (every
    cell amp != 0, so its chunks are staged whole).  Grid: ``shape``,
    ragged in every axis, an amp = 0 slab and wholly jet x rows.  Channels:
    all-far, all-near and mixed sets (the three evaluators of the TPU
    kernels), and 1, 33 and 1000 channels (not multiples of a group)."""
    import torch
    from rajepy_tpu_torch.ops import kernels as kn
    nu0 = 3.2e10
    tiles = rrl_factors(rng, (7,) + kn.TILE, dev)
    tiles[0][2] = 0.0
    tiles[0][4] = tiles[0][4] + 1e-6
    seg = np.array([0, 0, 3, 1, 3, 2, 0])
    nx, nz = 24, 200
    order, seg_start = (torch.as_tensor(a, device=dev)
                        for a in kn.segment_order(seg, 6))
    walk = (order, seg_start, nx, nz)
    cube = rrl_factors(rng, shape, dev)
    cube[0][:8] = 0.0
    cube[0][20:24] = cube[0][20:24] + 1e-6
    if not (bool(tiles[0][4].all()) and bool(cube[0][20:24].all())):
        raise AssertionError("the wholly jet tile or rows hold amp = 0")
    sets = dict(RRL_CHANNEL_SETS, **{'1 ch': (0.0, 0.0, 1),
                                     '33 ch': (-4e6, 4e6, 33),
                                     '1000 ch': (-5e7, 5e7, 1000)})
    for label, (lo, hi, n) in sets.items():
        fo = torch.linspace(lo, hi, n, dtype=torch.float32, device=dev)
        _, n_core, n_far = rrl_ops(fo, *tiles[:4])
        if label in RRL_CHANNEL_SETS and (
                (label == 'all-far') != (n_core == 0) or
                (label == 'all-near') != (n_far == 0)):
            raise AssertionError(f"channel set {label}: {n_core} core and "
                                 f"{n_far} wing cell-channels")
        got = kn.rrl_tiles(fo, *tiles, nu0, *walk)
        want = kn.rrl_tiles_plain(fo, *tiles, nu0, *walk)
        check(f'rrl_tiles_pallas maps, {label} ({n_core} core, {n_far} '
              f'wing)', got, want, KERNEL_RTOL)
        if got[:, 16:].abs().max() != 0:
            raise AssertionError("a tile position with no tile gave "
                                 "non-zero maps")
        got = kn.rrl_cube(fo, *cube, nu0)
        want = kn.rrl_cube_plain(fo, *cube, nu0)
        check(f'rrl_cube_pallas, {label}', got, want, KERNEL_RTOL)
        if got[:, :8].abs().max() != 0:
            raise AssertionError("the amp = 0 slab gave non-zero maps")
    fo = torch.linspace(-4e6, 4e6, 21, dtype=torch.float32, device=dev)
    got = kn.rrl_tile_partials(fo, *tiles, nu0)
    check('rrl_tiles_pallas per-tile partials, mixed', got,
          kn.rrl_tile_partials_plain(fo, *tiles, nu0), KERNEL_RTOL)
    if got[2].abs().max() != 0:
        raise AssertionError("an empty tile gave a non-zero partial")
    active = kn.rrl_row_activity(cube[0])
    if not torch.equal(active, kn.rrl_row_activity_plain(cube[0])):
        raise AssertionError("rrl_cube_pallas activity pass differs from "
                             "its plain version")
    print(f"  rrl_cube_pallas activity pass: {int(active.sum())} of "
          f"{active.numel()} row blocks flagged, equal to the plain version")


def products_from_maps(jm, st, a_map, em, freqs=FREQS):
    """continuum_rt_products' channel stage, from given epoch maps."""
    from rajepy_tpu_torch.ops import radtrans as rt
    t_0, reyn, csize, dist = jm._rt_constants()
    freqs = jm._freqs(freqs)
    taus = rt.tau_ff_channel_scale(freqs, t_0, reyn)[:, None, None] * \
        a_map[None]
    fluxes = rt.flux_ff_maps(freqs, taus, st.tbar, st.any_in, csize, dist)
    return em, taus, fluxes


def read_launches(path):
    from rajepy_tpu_torch.ops import kernels as kn
    launches = dict(kn.LAUNCHES)
    print(f"  launches in the {path} run: {launches}")
    return launches


def require_launched(launches, names, path):
    for name in names:
        if launches[name] < 1:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"{path} path")


def finite_nonzero(arrs, what):
    for arr in arrs:
        if not (np.all(np.isfinite(arr)) and np.abs(arr).max() > 0):
            raise AssertionError(f"non-finite or zero map: {what}")


def all_zero(arrs, what):
    for arr in arrs:
        if not (np.all(np.isfinite(arr)) and np.all(arr == 0)):
            raise AssertionError(f"the jet-free grid gave non-zero maps: "
                                 f"{what}")


def run_continuum(jm, empty, tmp):
    """The continuum main path, counted (phase 2a)."""
    import torch
    from rajepy_tpu_torch.io import fits as fitsio
    from rajepy_tpu_torch.ops import kernels as kn
    from rajepy_tpu_torch.utils import profiling
    print(f"phase 2a: continuum, {N_GRID}^3 x {len(FREQS)} channels, "
          f"{len(jm._burst_tuple())} bursts, float32")
    fill_key = 'grid fill (fields + fill factors)'
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kn.reset_launches()
    t_wall = time.perf_counter()
    profiling.collect_stage_times(True)
    runs = []
    for t_yr in EPOCHS_YR:
        jm.time = t_yr * YEAR
        runs.append(jm.continuum_rt_products(FREQS))
    fits_path = os.path.join(tmp, 'flux.fits')
    flux = jm.flux_ff(FREQS, savefits=fits_path)
    em = jm.emission_measure()
    fill_cold_s = profiling.stage_times()[fill_key]
    profiling.collect_stage_times(True)
    empty.time = EPOCHS_YR[0] * YEAR
    e_em, e_taus, e_fl = empty.continuum_rt_products(FREQS)
    e_em1 = empty.emission_measure()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t_wall
    launches = read_launches('continuum')
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fill_warm_s = profiling.stage_times()[fill_key]
    profiling.collect_stage_times(False)
    require_launched(launches, CONTINUUM_KERNELS, 'continuum')

    for (e, ta, fl), t_yr in zip(runs, EPOCHS_YR):
        if e.shape != (N_GRID, N_GRID) or \
                ta.shape != (len(FREQS), N_GRID, N_GRID) or \
                fl.shape != ta.shape:
            raise AssertionError(f"bad product shapes at {t_yr} yr")
        finite_nonzero((e, ta, fl), f"continuum at {t_yr} yr")
    # one summation order for one base and two: the same bits
    if not np.array_equal(flux, runs[-1][2]) or \
            not np.array_equal(em, runs[-1][0]):
        raise AssertionError("flux_ff/emission_measure differ from "
                             "continuum_rt_products")
    data, hdr = fitsio.read_fits(fits_path)
    if data.shape != (len(FREQS), N_GRID, N_GRID) or \
            not np.allclose(data, flux.transpose(0, 2, 1), rtol=1e-6,
                            atol=0):
        raise AssertionError("FITS product does not hold the flux maps")
    all_zero((e_em, e_taus, e_fl, e_em1), 'continuum')
    print(f"  products finite and non-zero; flux_ff and emission_measure "
          f"equal to continuum_rt_products' flux and EM bit for bit; FITS "
          f"{hdr['NAXIS1']}x"
          f"{hdr['NAXIS2']}x{hdr['NAXIS3']} {hdr['BUNIT']}")
    return launches, dict(fill_cold_s=fill_cold_s, fill_warm_s=fill_warm_s,
                          wall_s=wall_s, peak_gb=peak_gb)


def rrl_band(nu0):
    return (np.linspace(nu0 - 5e7, nu0 + 5e7, RRL_NCHAN),
            np.linspace(nu0 * (1 - 1e-4), nu0 * (1 + 1e-4), 16))


def run_rrl(jm, empty, tmp):
    """The RRL main path, counted (phase 2b)."""
    import torch
    from rajepy_tpu_torch.io import fits as fitsio
    from rajepy_tpu_torch.ops import kernels as kn
    from rajepy_tpu_torch.ops import radtrans as rt
    nu0 = rt.RRLCoeffs(RRL_LINE).nu0
    band, core16 = rrl_band(nu0)
    print(f"phase 2b: RRL {RRL_LINE} (nu0 {nu0:.6e} Hz), {N_GRID}^3 x "
          f"{RRL_NCHAN} channels over nu0 +- 5e7 Hz, float32, "
          f"{RRL_EPOCH_YR} yr")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kn.reset_launches()
    t_wall = time.perf_counter()
    jm.time = RRL_EPOCH_YR * YEAR
    em, tau_l, flux = jm.rrl_rt_products(RRL_LINE, band, contsub=False)
    n_em, n_tau, n_flux = jm.rrl_rt_products(RRL_LINE, band, contsub=False,
                                             lte=False)
    fits_path = os.path.join(tmp, 'tau_rrl.fits')
    tau16 = jm.optical_depth_rrl(RRL_LINE, core16, savefits=fits_path)
    flux16 = jm.flux_rrl(RRL_LINE, core16, contsub=False)
    empty.time = RRL_EPOCH_YR * YEAR
    e_em, e_tau, e_flux = empty.rrl_rt_products(RRL_LINE, band)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t_wall
    launches = read_launches('RRL')
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require_launched(launches, RRL_KERNELS, 'RRL')

    shape = (RRL_NCHAN, N_GRID, N_GRID)
    for name, arr in (('tau_l', tau_l), ('flux', flux), ('nonlte tau', n_tau),
                      ('nonlte flux', n_flux)):
        if arr.shape != shape:
            raise AssertionError(f"RRL {name}: shape {arr.shape}")
    finite_nonzero((em, tau_l, flux, n_em, n_tau, n_flux, tau16, flux16),
                   'RRL')
    if tau_l.min() < 0:
        raise AssertionError("negative LTE line opacity")
    b1, b2 = jm.departure_coefficients(RRL_LINE)
    if np.array_equal(n_tau, tau_l):
        raise AssertionError("the non-LTE opacity equals the LTE one")
    data, hdr = fitsio.read_fits(fits_path)
    if data.shape != (16, N_GRID, N_GRID) or \
            not np.allclose(data, tau16.transpose(0, 2, 1), rtol=1e-6,
                            atol=0):
        raise AssertionError("FITS product does not hold the RRL tau maps")
    all_zero((e_em, e_tau, e_flux), 'RRL')
    line_peak = np.unravel_index(np.argmax(tau_l), tau_l.shape)
    print(f"  products finite and non-zero; max tau_L {tau_l.max():.4e} at "
          f"channel {line_peak[0]}; non-LTE b_n1 = {b1:.6f}, b_n2 = "
          f"{b2:.6f}; FITS {hdr['NAXIS1']}x{hdr['NAXIS2']}x{hdr['NAXIS3']} "
          f"{hdr['BUNIT']}; jet-free grid all zero")
    return launches, dict(wall_s=wall_s, peak_gb=peak_gb, band=band,
                          core16=core16, nu0=nu0)


def rrl_tile_inputs(jm, freqs):
    """The tile kernel's inputs as the model's RRL path makes them, and its
    walk (order, seg_start, nx, nz)."""
    from rajepy_tpu_torch.ops import radtrans as rt
    temp_t, vy_t, ndxi_t, ds_t, inside_t, tss_t, order, seg_start = \
        jm._rrl_tiles()
    n_es_t = ndxi_t * jm._chi_from_packed(tss_t, jm.time)
    return (rt.rrl_kernel_inputs(rt.RRLCoeffs(RRL_LINE), jm._freqs(freqs),
                                 temp_t, n_es_t, vy_t, ds_t, inside_t),
            (order, seg_start, jm.nx, jm.nz))


def rrl_full_inputs(jm, freqs):
    """The cube kernel's inputs from the model's full grid."""
    from rajepy_tpu_torch.ops import radtrans as rt
    f = jm._ensure_fields()
    n_es = jm._nd_chi(f, jm.time) * f.xi
    ds = rt.path_length_cm(f.ff, f.area, jm.csize)
    return rt.rrl_kernel_inputs(rt.RRLCoeffs(RRL_LINE), jm._freqs(freqs),
                                f.temp, n_es, f.vy, ds, f.inside)


def rrl_products_plain(jm, band):
    """rrl_rt_products(contsub=False) through the plain versions of the
    tile kernels, on the model's own card tensors."""
    from rajepy_tpu_torch.ops import kernels as kn
    from rajepy_tpu_torch.ops import radtrans as rt
    inputs, walk = rrl_tile_inputs(jm, band)
    tau_l = kn.rrl_tiles_plain(*inputs, *walk)
    st = jm._rt_static()
    a_map, _ = kn.epoch_base_maps2_tiles_plain(
        st.a_t, st.em_t, st.tss_t, st.seg, jm.time, jm._burst_tuple(),
        jm.nx, jm.nz, jm._ts_pack_offset)
    t_0, reyn, csize, dist = jm._rt_constants()
    freqs = jm._freqs(band)
    tau_c = rt.tau_ff_channel_scale(freqs, t_0, reyn)[:, None, None] * \
        a_map[None]
    ints = rt.intensity_rrl_maps(freqs, st.tbar, tau_c, tau_l, st.any_in)
    fluxes = ints * rt.flux_scale_jy(csize, dist) + rt.flux_ff_maps(
        freqs, tau_c, st.tbar, st.any_in, csize, dist)
    return tau_l, fluxes, inputs, walk


def emergent_tile_args(jm):
    """The emergent tile kernel's arguments as the model's path makes them,
    and the segments' (x, z) tile coordinates."""
    cnu, hnuk, scale = jm._emergent_channels(jm._freqs(FREQS))
    temp_t, a_t, tss_t, _, seg_start, it, kt = jm._emergent_tiles()[:7]
    return ((cnu, hnuk, scale, temp_t, a_t, tss_t, seg_start, jm.time,
             jm._burst_tuple(), jm._ts_pack_offset), it, kt)


def emergent_full_args(jm):
    """The full-grid kernel's arguments from the model's own cubes
    (base = a chi^2, safe temperature): real jet cells, unlike the jet-free
    grid that takes this kernel on the main path."""
    import torch
    f = jm._ensure_fields()
    cnu, hnuk, scale = jm._emergent_channels(jm._freqs(FREQS))
    base = jm._rt_static().a * jm._chi2(f, jm.time)
    safe_t = torch.where(f.inside, f.temp, torch.ones_like(f.temp))
    return cnu, hnuk, scale, safe_t, base


def scan_channel_args(jm, c):
    """One channel's source B_nu(T) inside the jet and opacity
    scale[c] a chi^2, (nx, ny, nz) each, for the scan op."""
    import torch
    from rajepy_tpu_torch.ops import physics
    cnu, hnuk, scale, safe_t, base = emergent_full_args(jm)
    f = jm._ensure_fields()
    src = torch.where(f.inside, physics.blackbody_nu(jm._freqs(FREQS)[c],
                                                     safe_t),
                      torch.zeros_like(safe_t))
    return src, base * scale[c]


def run_emergent(jm, empty):
    """The emergent main path, counted (phase 2c): the flagship through the
    tile kernel, the jet-free grid through the full-grid kernel, and the
    scan op on one channel whose tau reaches 1 on the map."""
    import torch
    from rajepy_tpu_torch.ops import kernels as kn
    print(f"phase 2c: emergent, {N_GRID}^3 x {len(FREQS)} channels, "
          f"float32, {EMERGENT_EPOCH_YR} yr")
    jm.time = empty.time = EMERGENT_EPOCH_YR * YEAR
    taus = jm.continuum_rt_products(FREQS, as_numpy=False)[1]
    tau_max = taus.amax(dim=(1, 2)).cpu().numpy()
    c = int(np.flatnonzero(tau_max >= 1.0).max())
    scan_args = scan_channel_args(jm, c)
    del taus
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kn.reset_launches()
    t_wall = time.perf_counter()
    ints = jm.emergent_intensity_ff(FREQS)
    e_ints = empty.emergent_intensity_ff(FREQS)
    scan = kn.transfer_scan_maps(*scan_args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t_wall
    launches = read_launches('emergent')
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require_launched(launches, EMERGENT_KERNELS, 'emergent')

    if ints.shape != (len(FREQS), N_GRID, N_GRID):
        raise AssertionError(f"emergent maps: shape {ints.shape}")
    finite_nonzero((ints, scan[0].cpu().numpy()), 'emergent')
    all_zero((e_ints,), 'emergent')
    if empty._emergent_tiles() is not None:
        raise AssertionError("the jet-free grid has active tiles")
    print(f"  maps finite and non-zero, max I {ints.max():.4e} W m^-2 Hz^-1 "
          f"sr^-1; scan op on channel {c} ({FREQS[c]:.4e} Hz, max tau "
          f"{tau_max[c]:.4f}); jet-free grid all zero; run {wall_s:.4f} s "
          f"(flipped compaction, both grids, the scan op); peak memory "
          f"{peak_gb:.3f} GB")
    return launches, dict(c=c, scan=scan, scan_args=scan_args)


def run_pipeline(jm, log, tmp, smi):
    """The pipeline main path, counted (phase 2d): the bundled campaign
    through ``Pipeline.execute`` on the flagship model, its FITS products
    against the direct calls, then resume, reload and clobber."""
    import shutil
    import torch
    from rajepy_tpu_torch import Pipeline
    from rajepy_tpu_torch.io import fits as fitsio
    from rajepy_tpu_torch.ops import kernels as kn
    from rajepy_tpu_torch.utils import profiling
    from rajepy_tpu_torch.utils.misc import freq_str
    params = Pipeline.py_to_dict(os.path.join(
        HERE, 'rajepy_tpu_torch', 'data', 'example-pipeline-params.py'))
    dcy = os.path.join(tmp, 'campaign')
    params['dcys']['model_dcy'] = dcy
    params['rrls']['times'] = np.array([RRL_EPOCH_YR])
    pline = Pipeline(jm, params, log=log)
    runs = pline.runs
    kinds = [r.obs_type for r in runs]
    n_rrl = kinds.count('rrl')
    print(f"phase 2d: pipeline, {N_GRID}^3 float32, {len(runs)} runs: "
          f"{kinds.count('continuum')} continuum ("
          f"{len(runs[0].chan_freqs)} ch at {runs[0].freq:.1e} Hz, "
          f"{runs[0].year:g}-{runs[kinds.count('continuum') - 1].year:g} "
          f"yr), {n_rrl} {RRL_LINE} ({len(runs[-1].chan_freqs)} ch, "
          f"{runs[-1].year:g} yr)")
    if kinds != ['continuum'] * 6 + ['rrl'] or \
            len(runs[-1].chan_freqs) != RRL_NCHAN:
        raise AssertionError(f"unexpected run matrix: {kinds}")
    quiet = dict(simobserve=False, verbose=False, plot=False)

    # every stage the pipeline records, in order, beside the totals
    events = []
    record = profiling.record_stage

    def recording(name, seconds):
        events.append((name, seconds))
        record(name, seconds)

    profiling.record_stage = recording
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        profiling.collect_stage_times(True)
        kn.reset_launches()
        t_wall = time.perf_counter()
        pline.execute(**quiet)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t_wall
    finally:
        profiling.record_stage = record
    launches = read_launches('pipeline')
    totals = profiling.stage_times()
    profiling.collect_stage_times(False)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches['epoch_base_maps2_tiles'] != len(runs) or \
            launches['rrl_tiles_pallas'] != n_rrl:
        raise AssertionError(
            f"Pipeline.execute must launch the dual-base epoch kernel once "
            f"per run ({len(runs)}) and the RRL tile kernel once per RRL run "
            f"({n_rrl}): {launches}")
    if pline.model is not jm:
        raise AssertionError("a first execute replaced the model")

    # one line per run: the stages between two device-compute records
    per_run = []
    for name, seconds in events:
        if name == STAGE_COMPUTE:
            per_run.append({})
        if per_run:
            per_run[-1].setdefault(name, []).append(seconds)
    if len(per_run) != len(runs):
        raise AssertionError(f"{len(per_run)} runs recorded their stages")
    for i, (run, st) in enumerate(zip(runs, per_run)):
        copy_s = st[STAGE_COPY][0]
        print(f"  run {i + 1} ({run.obs_type}, {run.year:g} yr, "
              f"{len(run.chan_freqs)} ch): device compute "
              f"{st[STAGE_COMPUTE][0] * 1e3:.4f} ms, copy-out "
              f"{copy_s * 1e3:.4f} ms, FITS writes and flux sums "
              f"{(st[STAGE_COPY_WRITE][0] - copy_s) * 1e3:.4f} ms, "
              f"checkpoint {st[STAGE_CKPT][0] * 1e3:.4f} ms [{smi}]")
    final_ckpt = per_run[-1][STAGE_CKPT][1]
    print(f"  execute {wall_s:.4f} s in all; stage totals (stage_times): "
          f"device compute {totals[STAGE_COMPUTE]:.4f} s, copy-out "
          f"{totals[STAGE_COPY]:.4f} s, copy-out with FITS writes "
          f"{totals[STAGE_COPY_WRITE]:.4f} s, checkpoints "
          f"{totals[STAGE_CKPT]:.4f} s (the closing one "
          f"{final_ckpt:.4f} s); peak device memory {peak_gb:.3f} GB "
          f"[{smi}]")

    # names, flags and results; then every product against the direct call
    n_bytes, worst = 0, 0.0
    for run in runs:
        what = freq_str(run.freq) if run.obs_type == 'continuum' \
            else run.line
        day = f'Day{int(run.year * 365.0)}'
        for prefix, path in (('EM', run.fits_em), ('Tau', run.fits_tau),
                             ('Flux', run.fits_flux)):
            want = os.path.join(dcy, day, what, f'{prefix}_{day}_{what}.fits')
            if path != want or not os.path.isfile(path):
                raise AssertionError(f"{path} is not the product {want}")
            n_bytes += os.path.getsize(path)
        # the bundled runs are configured for synthetic observations too,
        # so an execute without them leaves them open for a later resume
        if run.completed != (not run.simobserve):
            raise AssertionError(f"run.completed = {run.completed} with "
                                 f"run.simobserve = {run.simobserve}")
        flux = np.asarray(run.results['flux'])
        if flux.shape != (() if run.obs_type == 'continuum' else
                          (RRL_NCHAN,)) or \
                not (np.all(np.isfinite(flux)) and np.all(flux > 0)):
            raise AssertionError(f"results['flux'] of {day}/{what}: {flux}")
        jm.time = run.year * YEAR
        if run.obs_type == 'continuum':
            direct = jm.continuum_rt_products(run.chan_freqs)
        else:
            direct = jm.rrl_rt_products(run.line, run.chan_freqs,
                                        contsub=False)
        finite_nonzero(direct, f"direct call for {day}/{what}")
        for path, arr in zip((run.fits_em, run.fits_tau, run.fits_flux),
                             direct):
            data, hdr = fitsio.read_fits(path)
            want = np.swapaxes(arr, -1, -2)
            if hdr['BITPIX'] != -32 or data.shape != want.shape:
                raise AssertionError(f"{path}: BITPIX {hdr['BITPIX']}, "
                                     f"shape {data.shape}")
            data -= want
            err = float(np.abs(data).max() / np.abs(want).max())
            worst = max(worst, err)
            if not err <= PIPELINE_RTOL:
                raise AssertionError(f"{path} differs from the direct call: "
                                     f"rel err {err:.3e} > {PIPELINE_RTOL:g}")
            del data, want
        del direct
    print(f"  {3 * len(runs)} FITS products ({n_bytes} bytes) under "
          f"Day<d>/<freq|line>/ against the direct calls: max rel err "
          f"{worst:.3e} (tolerance {PIPELINE_RTOL:g}); "
          f"results['flux'] finite and positive; completed = "
          f"{[r.completed for r in runs]} (runs configured for synthetic "
          f"observations stay open without them)")

    # resume: nothing launched, nothing rewritten; the saved state reloads
    def stamps():
        return {p: os.stat(p).st_mtime_ns for r in runs
                for p in (r.fits_em, r.fits_tau, r.fits_flux)}

    before = stamps()
    table = str(pline)
    kn.reset_launches()
    t0 = time.perf_counter()
    pline.execute(**quiet)
    resume_s = time.perf_counter() - t0
    if any(kn.LAUNCHES.values()) or stamps() != before:
        raise AssertionError(f"the second execute launched kernels or "
                             f"rewrote products: {dict(kn.LAUNCHES)}")
    if pline.model is jm or pline.model.device != jm.device or \
            pline.model.dtype != jm.dtype:
        raise AssertionError("resume did not reload the model on its "
                             "device at its precision")
    loaded = Pipeline.load_pipeline(pline.save_file)
    if str(loaded) != table or len(loaded.runs) != len(runs):
        raise AssertionError("load_pipeline gave another run table")
    del pline
    # clobber on one run: recomputed and rewritten, the others untouched
    loaded.runs = loaded.runs[:1]
    kn.reset_launches()
    loaded.execute(resume=False, clobber=True, **quiet)
    after = stamps()
    first = (runs[0].fits_em, runs[0].fits_tau, runs[0].fits_flux)
    if kn.LAUNCHES['epoch_base_maps2_tiles'] != 1 or \
            not all(after[p] > before[p] for p in first) or \
            any(after[p] != before[p] for p in before if p not in first):
        raise AssertionError("clobber=True on one run must recompute and "
                             "rewrite that run alone")
    print(f"  second execute {resume_s:.4f} s: no launch, no product "
          f"rewritten (model reloaded from jetmodel.save on "
          f"{loaded.model.device}); load_pipeline gives the same run "
          f"table; clobber=True on run 1 recomputed it alone [{smi}]")
    del loaded
    shutil.rmtree(dcy)
    torch.cuda.empty_cache()
    return launches


def synthobs_mask(sky_hdr, img_hdr, ny, nx):
    """simulate_observation's CLEAN box: the model's extent in the image."""
    cell_as = abs(float(img_hdr['CDELT2'])) * 3600.0
    half_x = int(np.ceil(nx * abs(float(sky_hdr['CDELT1'])) * 3600.0 /
                         cell_as / 2.0)) + 2
    half_y = int(np.ceil(ny * abs(float(sky_hdr['CDELT2'])) * 3600.0 /
                         cell_as / 2.0)) + 2
    n = SYNTHOBS_IMSIZE
    mask = np.zeros((n, n))
    c0 = n // 2
    mask[max(c0 - half_y, 0):c0 + half_y,
         max(c0 - half_x, 0):c0 + half_x] = 1.0
    return mask, cell_as


def synthobs_card_vs_cpu(run, smi):
    """Run 1's synthetic observation through the port's synthobs functions
    on the card and on the CPU, each stage from the same inputs; the card's
    stages timed by CUDA events (phase 2e)."""
    import torch
    from rajepy_tpu_torch import constants as cnsts
    from rajepy_tpu_torch.io import fits as fitsio
    from rajepy_tpu_torch.synthobs import imaging, observatories, sampler
    sky, sky_hdr = fitsio.read_fits(run.fits_flux)
    _, img_hdr = fitsio.read_fits(run.products['clean_image'])
    with np.load(run.products['ms_clean']) as f:
        uvw, freqs = f['uvw'], f['freqs']
        clean_saved = f['vis_re'] + 1j * f['vis_im']
    with np.load(run.products['ms_noisy']) as f:
        noisy = f['vis_re'] + 1j * f['vis_im']
    cell_model = abs(float(sky_hdr['CDELT2'])) * np.pi / 180.0
    dish = float(np.mean(observatories.read_antenna_config(
        observatories.cfg_file(*run.tscop))['diam']))
    mask, cell_as = synthobs_mask(sky_hdr, img_hdr, *sky.shape[-2:])
    cell = cell_as * cnsts.ARCSEC
    lam = cnsts.C / freqs
    us = (uvw[None, :, 0] / lam[:, None]).ravel()
    vs = (uvw[None, :, 1] / lam[:, None]).ravel()

    def timed(fn):
        """(result, ms) of one call by the host clock, the card idle on
        both sides."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    out, ms = {}, {}
    for dev in ('cuda', 'cpu'):
        def t(a):
            return torch.as_tensor(a, dtype=torch.float64, device=dev)
        sky_d = t(sky)
        vis, ms_vis = timed(lambda: sampler.sample_vis_cube(
            sky_d, cell_model, uvw, freqs, apply_pb=True,
            dish_diameter_m=dish, centre='fits'))
        vis_n = torch.as_tensor(noisy.ravel(), device=dev)
        wb, ms_w = timed(lambda: imaging.briggs_weights(
            t(us), t(vs), t(np.ones_like(us)), SYNTHOBS_IMSIZE, cell))
        (dirty, psf), ms_g = timed(lambda: imaging.grid_and_image(
            t(us), t(vs), vis_n, wb, SYNTHOBS_IMSIZE, cell))
        out[dev] = dict(vis=torch.view_as_real(vis).cpu(), dirty=dirty.cpu(),
                        psf=psf.cpu())
        ms[dev] = dict(sample=ms_vis, weights=ms_w, grid=ms_g)
    if not np.array_equal(torch.view_as_complex(out['cuda']['vis']).numpy(),
                          clean_saved):
        raise AssertionError("sample_vis_cube on the card is not the "
                             "pipeline's clean visibility set bit for bit")
    errs = {'vis': check('sample_vis_cube (clean vis), card vs CPU',
                         out['cuda']['vis'], out['cpu']['vis'],
                         SYNTHOBS_RTOL)[0]}
    for name in ('dirty', 'psf'):
        errs[name] = check(f'grid_and_image {name}, card vs CPU',
                           out['cuda'][name], out['cpu'][name],
                           SYNTHOBS_RTOL)[0]
    # CLEAN and restore on the same inputs: the card's dirty image and PSF
    dirty, psf = out['cuda']['dirty'].numpy(), out['cuda']['psf'].numpy()
    thr = 3.0 * float(np.std(dirty[mask == 0]))
    beam = imaging.fit_psf_beam(psf, cell)
    kern = imaging.gaussian_beam_kernel(SYNTHOBS_IMSIZE, cell, *beam)
    clean = {}
    for dev in ('cuda', 'cpu'):
        d, p = (torch.as_tensor(a, device=dev) for a in (dirty, psf))
        (mdl, res, its), ms_c = timed(lambda: imaging.hogbom_clean(
            d, p, mask, gain=0.1, niter=500, threshold=thr))
        rest, ms_r = timed(lambda: imaging.restore(mdl, res, kern))
        clean[dev] = (mdl.cpu(), res.cpu(), its, rest.cpu())
        ms[dev].update(clean=ms_c, restore=ms_r)
    (m_g, r_g, n_g, rest_g), (m_c, r_c, n_c, rest_c) = \
        clean['cuda'], clean['cpu']
    if n_g != n_c or not torch.equal(m_g, m_c) or not torch.equal(r_g, r_c):
        raise AssertionError(
            f"hogbom_clean on the card is not the CPU's bit for bit: "
            f"n_iter {n_g} / {n_c}, model max diff "
            f"{float((m_g - m_c).abs().max()):.3e}, residual max diff "
            f"{float((r_g - r_c).abs().max()):.3e}")
    print(f"  hogbom_clean, card vs CPU on the same dirty image and PSF: "
          f"model and residual bit for bit, n_iter {n_g} on both "
          f"(threshold {thr:.3e} Jy/beam)")
    errs['restore'] = check('restore, card vs CPU', rest_g, rest_c,
                            SYNTHOBS_RTOL)[0]
    errs.update(deconvolvers_card_vs_cpu(run, dirty, psf, mask, cell, thr,
                                         smi))
    # the CLEAN loop alone, warm, on the card: iterations per second
    d, p = (torch.as_tensor(a, device='cuda') for a in (dirty, psf))
    clean_ms = [timed(lambda: imaging.hogbom_clean(
        d, p, mask, gain=0.1, niter=500, threshold=thr))[1]
        for _ in range(3)]
    it_s = n_g / (statistics.median(clean_ms) / 1e3)
    for dev in ('cuda', 'cpu'):
        print(f"  run 1 on the {dev}: sample_vis_cube "
              f"{ms[dev]['sample']:.4f} ms, briggs_weights "
              f"{ms[dev]['weights']:.4f} ms, grid_and_image "
              f"{ms[dev]['grid']:.4f} ms, hogbom_clean "
              f"{ms[dev]['clean']:.4f} ms, restore "
              f"{ms[dev]['restore']:.4f} ms (one call each, the card's "
              f"the first in the process; host clock)")
    print(f"  hogbom_clean warm on the card: {n_g} iterations in "
          f"{statistics.median(clean_ms):.4f} ms (median of 3: "
          f"{', '.join(f'{x:.4f}' for x in clean_ms)}), {it_s:.1f} "
          f"iterations per second [{smi}]")
    return errs, it_s


def deconvolvers_card_vs_cpu(run, dirty, psf, mask, cell, thr, smi):
    """Clark and multiscale CLEAN on run 1's dirty image and PSF, and
    mtmfs on its two channels' Taylor stacks, each on the card and on the
    CPU from the same inputs (phase 2e): the same iteration count, model
    and residual within SYNTHOBS_RTOL of the dirty peak."""
    import torch
    from rajepy_tpu_torch import constants as cnsts
    from rajepy_tpu_torch.synthobs import imaging
    with np.load(run.products['ms_noisy']) as f:
        uvw, freqs = f['uvw'], f['freqs']
        noisy = f['vis_re'] + 1j * f['vis_im']
    # the mtmfs inputs: each channel imaged on its own on the card, then
    # the Taylor stacks about the run's centre frequency
    planes = []
    for c, nu in enumerate(freqs):
        us, vs = (torch.as_tensor(uvw[:, i] * nu / cnsts.C, device='cuda')
                  for i in (0, 1))
        wb = imaging.briggs_weights(us, vs, torch.ones_like(us),
                                    SYNTHOBS_IMSIZE, cell)
        planes.append(imaging.grid_and_image(
            us, vs, torch.as_tensor(noisy[c], device='cuda'), wb,
            SYNTHOBS_IMSIZE, cell))
    dirty_t, psf_m = (a.cpu() for a in imaging.taylor_stacks(
        torch.stack([d for d, _ in planes]),
        torch.stack([p for _, p in planes]), freqs, float(run.freq)))
    thr_t = 3.0 * float(np.std(dirty_t[0].numpy()[mask == 0]))
    cases = {
        'clark_clean': ((dirty, psf), lambda d, p: imaging.clark_clean(
            d, p, mask, gain=0.1, niter=500, threshold=thr,
            cycleniter=100)),
        'multiscale_clean': ((dirty, psf),
                             lambda d, p: imaging.multiscale_clean(
                                 d, p, mask, scales=(0, 3, 10), gain=0.1,
                                 niter=500, threshold=thr)),
        'mtmfs_clean': ((dirty_t.numpy(), psf_m.numpy()),
                        lambda d, p: imaging.mtmfs_clean(
                            d, p, mask, gain=0.1, niter=500,
                            threshold=thr_t))}
    errs = {}
    for name, (inputs, fn) in cases.items():
        out = {}
        for dev in ('cuda', 'cpu'):
            d, p = (torch.as_tensor(a, device=dev) for a in inputs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m, r, n_it = fn(d, p)
            torch.cuda.synchronize()
            out[dev] = (m.cpu(), r.cpu(), n_it,
                        (time.perf_counter() - t0) * 1e3)
        (m_g, r_g, n_g, ms_g), (m_c, r_c, n_c, ms_c) = out['cuda'], \
            out['cpu']
        peak = float(np.abs(inputs[0]).max())
        err = max(float((m_g - m_c).abs().max()),
                  float((r_g - r_c).abs().max())) / peak
        what = 'Taylor stacks' if name == 'mtmfs_clean' else \
            'dirty image and PSF'
        print(f"  {name}, card vs CPU on run 1's {what}: "
              f"{n_g} / {n_c} iterations, card {ms_g:.4f} ms, CPU "
              f"{ms_c:.4f} ms (one call each, host clock); model and "
              f"residual max diff {err:.3e} of the dirty peak (tolerance "
              f"{SYNTHOBS_RTOL:g}) [{smi}]")
        if n_g != n_c or not err <= SYNTHOBS_RTOL or not (
                torch.isfinite(m_g).all() and torch.isfinite(r_g).all()):
            raise AssertionError(f"{name} on the card differs from the "
                                 f"CPU: {n_g} / {n_c} iterations, {err:.3e}")
        errs[name] = err
    return errs


def run_synthobs(jm, log, tmp, smi, plot):
    """The synthetic observations, counted (phase 2e): the bundled campaign
    as shipped through ``Pipeline.execute`` with ``simobserve`` at its
    default on the flagship model, and ``plot`` at its default (True)
    where matplotlib can be imported; its products and figures, the card
    against the CPU, the noise, a deterministic repeat and a resume."""
    import shutil
    import torch
    from rajepy_tpu_torch import Pipeline
    from rajepy_tpu_torch.io import fits as fitsio
    from rajepy_tpu_torch.ops import kernels as kn
    from rajepy_tpu_torch.synthobs import observatories, simulate_observation
    from rajepy_tpu_torch.utils import profiling
    params = Pipeline.py_to_dict(os.path.join(
        HERE, 'rajepy_tpu_torch', 'data', 'example-pipeline-params.py'))
    dcy = os.path.join(tmp, 'synthobs')
    params['dcys']['model_dcy'] = dcy
    pline = Pipeline(jm, params, log=log)
    runs = pline.runs
    if [r.obs_type for r in runs] != ['continuum'] * 6 or \
            not all(r.simobserve for r in runs):
        raise AssertionError("the bundled campaign is not six continuum "
                             "runs configured for synthetic observations")
    print(f"phase 2e: synthetic observations, {N_GRID}^3 float32, "
          f"{len(runs)} continuum runs ({len(runs[0].chan_freqs)} ch at "
          f"{runs[0].freq:.1e} Hz, {runs[0].year:g}-{runs[-1].year:g} yr, "
          f"{runs[0].tscop[0]} {runs[0].tscop[1]}, t_obs {runs[0].t_obs:g} "
          f"s): execute(plot={plot}, resume=False, clobber=True)")

    events = []
    record = profiling.record_stage

    def recording(name, seconds):
        events.append((name, seconds))
        record(name, seconds)

    profiling.record_stage = recording
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        profiling.collect_stage_times(True)
        kn.reset_launches()
        t_wall = time.perf_counter()
        pline.execute(plot=plot, verbose=False, resume=False, clobber=True)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t_wall
    finally:
        profiling.record_stage = record
    launches = read_launches('synthobs')
    totals = profiling.stage_times()
    profiling.collect_stage_times(False)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches['epoch_base_maps2_tiles'] != len(runs):
        raise AssertionError(f"execute with synthetic observations must "
                             f"launch the dual-base epoch kernel once per "
                             f"run ({len(runs)}): {launches}")

    # one line per run: its stages between two device-compute records
    per_run = []
    for name, seconds in events:
        if name == STAGE_COMPUTE:
            per_run.append({})
        if per_run:
            key = next((k for k in SYNTHOBS_STAGES if name.startswith(k)),
                       name)
            per_run[-1][key] = per_run[-1].get(key, 0.0) + seconds
    if len(per_run) != len(runs) or \
            not all(k in st for st in per_run for k in SYNTHOBS_STAGES):
        raise AssertionError(f"the runs recorded these stages: {per_run}")
    for i, (run, st) in enumerate(zip(runs, per_run)):
        print(f"  run {i + 1} ({run.year:g} yr): RT device compute "
              f"{st[STAGE_COMPUTE] * 1e3:.4f} ms; " + ', '.join(
                  f"{k.replace('synthobs: ', '')} {st[k] * 1e3:.4f} ms"
                  for k in SYNTHOBS_STAGES) + f" [{smi}]")
    so_total = sum(v for k, v in totals.items()
                   if k.startswith(SYNTHOBS_STAGES))
    if plot:
        figures = list(PIPELINE_FIGURES) + sorted({
            os.path.relpath(os.path.join(os.path.dirname(r.rt_dcy),
                                         'ModelPlot.pdf'), dcy)
            for r in runs}) + [f'RadioSED{y:.1f}yrPlot.png'
                               for y in sorted({r.year for r in runs})]
        for name in figures:
            path = os.path.join(dcy, name)
            if not os.path.isfile(path) or os.path.getsize(path) <= 1000:
                raise AssertionError(f"execute(plot=True) wrote no figure "
                                     f"{name}")
        print(f"  figures: {len(figures)} files ({', '.join(figures)}); "
              f"stage 'plots' {totals['plots']:.4f} s [{smi}]")
    else:
        print("  figures skipped (no matplotlib): execute(plot=False)")
    print(f"  execute {wall_s:.4f} s in all, of which the synthetic "
          f"observations' stages {so_total:.4f} s; stage totals: " +
          ', '.join(f"{k} {v:.4f} s" for k, v in sorted(totals.items())) +
          f"; peak device memory {peak_gb:.3f} GB [{smi}]")

    # runs and files
    noise_err = 0.0
    for i, run in enumerate(runs):
        if not run.completed:
            raise AssertionError(f"run {i + 1} did not complete")
        prods = run.products
        for key in ('ms_clean', 'ms_noisy', 'clean_image', 'estimates',
                    'imfit'):
            if not os.path.isfile(prods.get(key, '')):
                raise AssertionError(f"run {i + 1}: no {key} product")
        img, hdr = fitsio.read_fits(prods['clean_image'])
        if img.shape != (SYNTHOBS_IMSIZE, SYNTHOBS_IMSIZE) or \
                hdr['BUNIT'] != 'Jy/beam' or \
                not all(k in hdr for k in ('BMAJ', 'BMIN', 'BPA')) or \
                not np.all(np.isfinite(img)) or not img.max() > 0:
            raise AssertionError(f"run {i + 1}: restored image {img.shape}, "
                                 f"BUNIT {hdr.get('BUNIT')}")
        fit = run.results.get('imfit')
        flux = run.results['flux']
        if not fit or not fit['Peak']['val'] > 0 or not flux > 0:
            raise AssertionError(f"run {i + 1}: imfit {fit}, flux {flux}")
        with np.load(prods['ms_clean']) as fc, \
                np.load(prods['ms_noisy']) as fn:
            d = (fn['vis_re'] - fc['vis_re'], fn['vis_im'] - fc['vis_im'])
            sigma = float(fn['sigma'])
            n_vis = fc['vis_re'].size
        for part in d:
            noise_err = max(noise_err, abs(float(part.std()) / sigma - 1.0))
        print(f"  run {i + 1}: imfit peak {fit['Peak']['val']:.6e} "
              f"{fit['Peak']['unit']}, integrated {fit['I']['val']:.6e} "
              f"{fit['I']['unit']}; results['flux'] {flux:.6e} Jy; beam "
              f"{hdr['BMAJ'] * 3600:.4f}\" x {hdr['BMIN'] * 3600:.4f}\" at "
              f"{hdr['BPA']:.2f} deg; {n_vis} visibilities, sigma "
              f"{sigma:.6e} Jy")
    if not noise_err <= SYNTHOBS_NOISE_RTOL:
        raise AssertionError(f"std(noisy - clean) is {noise_err:.4f} away "
                             f"from sigma (tolerance {SYNTHOBS_NOISE_RTOL})")
    print(f"  noise: std(noisy - clean) of each part within {noise_err:.5f} "
          f"of sigma over each run's {n_vis} visibilities (tolerance "
          f"{SYNTHOBS_NOISE_RTOL:g})")

    # the card against the CPU on run 1
    errs, it_s = synthobs_card_vs_cpu(runs[0], smi)

    # a second observation of run 1 on the card: the same bits
    run = runs[0]

    def vis_and_image():
        with np.load(run.products['ms_clean']) as fc, \
                np.load(run.products['ms_noisy']) as fn:
            arrs = [f[k] for f in (fc, fn) for k in ('vis_re', 'vis_im')]
        return arrs + [fitsio.read_fits(run.products['clean_image'])[0]]

    first = vis_and_image()
    simulate_observation(pline, run, min_el=params['min_el'])
    if not all(np.array_equal(a, b) for a, b in zip(first, vis_and_image())):
        raise AssertionError("a second simulate_observation of run 1 on "
                             "the card gave other visibilities or another "
                             "restored image")
    print("  a second simulate_observation of run 1 on the card: the same "
          "visibilities and restored image bit for bit")

    # resume: every run is complete, so nothing is launched or rewritten
    def stamps():
        return {p: os.stat(p).st_mtime_ns for r in runs
                for p in list(r.products.values()) + [r.fits_flux]}

    before = stamps()
    kn.reset_launches()
    t0 = time.perf_counter()
    pline.execute(plot=False, verbose=False, resume=True)
    resume_s = time.perf_counter() - t0
    if any(kn.LAUNCHES.values()) or stamps() != before:
        raise AssertionError(f"the resumed execute launched kernels or "
                             f"rewrote products: {dict(kn.LAUNCHES)}")
    print(f"  second execute (resume=True) {resume_s:.4f} s: no launch, "
          f"none of the {len(before)} products rewritten [{smi}]")
    # run 1's uv tracks and first channel: phase 2i fits visibilities
    # on them
    with np.load(run.products['ms_noisy']) as fn:
        uv1 = {'uvw': fn['uvw'], 'freq': float(run.chan_freqs[0]),
               'time': run.year * YEAR, 'cfg': ' '.join(run.tscop),
               'n_ant': observatories.read_antenna_config(
                   observatories.cfg_file(*run.tscop))['xyz'].shape[0]}
    del pline
    shutil.rmtree(dcy)
    torch.cuda.empty_cache()
    return launches, {'wall_s': wall_s, 'it_s': it_s, 'peak_gb': peak_gb,
                      'errs': errs, 'uv1': uv1}


def cube_card_vs_cpu(run, img_hdr, smi):
    """``imaging.clean_cube`` on CUBE_CHECK_NCHAN channels of the observed
    RRL run around nu0, on the card and on the CPU (phase 2f): restored
    and dirty cubes to SYNTHOBS_RTOL of each channel's peak; the batched
    Hogbom on the card's dirty images, PSFs and thresholds bit for bit on
    the CPU; a repeat on the card and another channel block bit for
    bit."""
    import torch
    from rajepy_tpu_torch import constants as cnsts
    from rajepy_tpu_torch.io import fits as fitsio
    from rajepy_tpu_torch.synthobs import imaging
    sky_hdr = fitsio.read_fits(run.fits_flux)[1]
    with np.load(run.products['ms_noisy']) as f:
        uvw, freqs = f['uvw'], f['freqs']
        c0 = int(np.argmin(np.abs(freqs - run.freq)))
        sel = slice(c0 - CUBE_CHECK_NCHAN // 2, c0 + CUBE_CHECK_NCHAN // 2)
        noisy = f['vis_re'][sel] + 1j * f['vis_im'][sel]
    freqs = freqs[sel]
    mask, cell_as = synthobs_mask(sky_hdr, img_hdr, sky_hdr['NAXIS2'],
                                  sky_hdr['NAXIS1'])
    cell = cell_as * cnsts.ARCSEC
    kern = imaging.gaussian_beam_kernel(
        SYNTHOBS_IMSIZE, cell, np.radians(img_hdr['BMAJ']),
        np.radians(img_hdr['BMIN']), img_hdr['BPA'])
    real = imaging._hogbom

    def cube(dev, **kw):
        """clean_cube's (restored, dirty) and every block's CLEAN inputs
        and outputs, and the call's time."""
        blocks = []

        def spy(*args, **kwargs):
            out = real(*args, **kwargs)
            blocks.append((args[:4], out))
            return out

        imaging._hogbom = spy
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = imaging.clean_cube(
                uvw, freqs, torch.as_tensor(noisy, device=dev),
                np.ones(uvw.shape[0]), SYNTHOBS_IMSIZE, cell, mask, kern,
                **kw)
            torch.cuda.synchronize()
        finally:
            imaging._hogbom = real
        return res, blocks, (time.perf_counter() - t0) * 1e3

    (rest_g, dirty_g), blocks_g, ms_g = cube('cuda')
    (rest_c, dirty_c), _, ms_c = cube('cpu')
    errs = {}
    for name, g, c in (('dirty', dirty_g, dirty_c),
                       ('restored', rest_g, rest_c)):
        peak = c.abs().flatten(1).max(1).values
        errs[f'cube {name}'] = float(((g.cpu() - c).abs().flatten(1)
                                      .max(1).values / peak).max())
        print(f"  clean_cube {name}, {len(freqs)} channels around nu0, "
              f"card vs CPU: max diff {errs[f'cube {name}']:.3e} of each "
              f"channel's peak (tolerance {SYNTHOBS_RTOL:g})")
        if not errs[f'cube {name}'] <= SYNTHOBS_RTOL:
            raise AssertionError(f"clean_cube {name} on the card differs "
                                 f"from the CPU's")
    # the batched Hogbom on the card's own inputs, on the CPU
    (args, (m_g, r_g, n_g)), = blocks_g
    m_c, r_c, n_c = real(*(a.cpu() if isinstance(a, torch.Tensor) else a
                           for a in args), gain=0.1, niter=500)
    if not (torch.equal(m_g.cpu(), m_c) and torch.equal(r_g.cpu(), r_c)
            and torch.equal(n_g.cpu(), n_c)):
        raise AssertionError("the batched Hogbom on the card is not the "
                             "CPU's bit for bit on the same inputs")
    print(f"  batched Hogbom on the card's dirty images, PSFs and "
          f"thresholds: model, residual and counts bit for bit on the CPU "
          f"({n_c.tolist()} iterations); clean_cube {ms_g:.4f} ms on the "
          f"card, {ms_c:.4f} ms on the CPU (one call each, host clock)")
    # a repeat, and blocks of CUBE_CHECK_BLOCK channels, on the card
    for label, kw in (('a repeat', {}),
                      (f'blocks of {CUBE_CHECK_BLOCK}',
                       {'chan_block': CUBE_CHECK_BLOCK})):
        (rest, dirty), blocks, _ = cube('cuda', **kw)
        m, r, n = (torch.cat([b[1][i] for b in blocks]) for i in range(3))
        if not (torch.equal(m, m_g) and torch.equal(r, r_g) and
                torch.equal(n, n_g) and torch.equal(rest, rest_g) and
                torch.equal(dirty, dirty_g)):
            raise AssertionError(f"clean_cube on the card, {label}: not "
                                 f"the first call's bits")
        print(f"  clean_cube on the card, {label} ({len(blocks)} "
              f"block(s)): models, residuals, counts, restored and dirty "
              f"cubes bit for bit the first call's [{smi}]")
    args = (uvw, freqs, torch.as_tensor(noisy, device='cuda'),
            np.ones(uvw.shape[0]), SYNTHOBS_IMSIZE, cell, mask, kern)
    return errs, (args, rest_g, dirty_g)


def run_cube_observation(jm, log, tmp, smi):
    """The line-cube synthetic observation, counted (phase 2f): the bundled
    pipeline with its H58a run alone through ``Pipeline.execute`` with
    ``simobserve`` at its default on the flagship model; its products, the
    FITS cube against the cube in memory, and clean_cube card against
    CPU."""
    import shutil
    import torch
    from rajepy_tpu_torch import Pipeline
    from rajepy_tpu_torch.io import fits as fitsio
    from rajepy_tpu_torch.ops import kernels as kn
    from rajepy_tpu_torch.synthobs import imaging
    from rajepy_tpu_torch.utils import profiling
    params = Pipeline.py_to_dict(os.path.join(
        HERE, 'rajepy_tpu_torch', 'data', 'example-pipeline-params.py'))
    dcy = os.path.join(tmp, 'cube')
    params['dcys']['model_dcy'] = dcy
    params['rrls']['times'] = np.array([RRL_EPOCH_YR])
    params['continuum']['times'] = np.array([])
    pline = Pipeline(jm, params, log=log)
    runs = pline.runs
    if len(runs) != 1 or runs[0].obs_type != 'rrl' or \
            not runs[0].simobserve or len(runs[0].chan_freqs) != RRL_NCHAN:
        raise AssertionError("the campaign is not one observed RRL run of "
                             f"{RRL_NCHAN} channels")
    run = runs[0]
    print(f"phase 2f: line-cube observation, {N_GRID}^3 float32, "
          f"{run.line} ({len(run.chan_freqs)} ch of {run.chanwidth:g} Hz, "
          f"{run.year:g} yr, {run.tscop[0]} {run.tscop[1]}, t_obs "
          f"{run.t_obs:g} s, t_int {run.t_int:g} s): execute(plot=False, "
          f"resume=False, clobber=True)")

    events, cubes = [], {}
    record = profiling.record_stage
    real = imaging.clean_cube

    def recording(name, seconds):
        events.append((name, seconds))
        record(name, seconds)

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        cubes.update(restored=out[0], info=kwargs.get('info'))
        return out

    profiling.record_stage = recording
    imaging.clean_cube = spy
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        profiling.collect_stage_times(True)
        kn.reset_launches()
        t_wall = time.perf_counter()
        pline.execute(plot=False, verbose=False, resume=False, clobber=True)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t_wall
    finally:
        profiling.record_stage = record
        imaging.clean_cube = real
    launches = read_launches('cube')
    totals = profiling.stage_times()
    profiling.collect_stage_times(False)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches['epoch_base_maps2_tiles'] != 1 or \
            launches['rrl_tiles_pallas'] != 1:
        raise AssertionError(f"the observed RRL run must launch the "
                             f"dual-base epoch kernel and the RRL tile "
                             f"kernel once each: {launches}")
    stage = {k: sum(v for name, v in totals.items() if name.startswith(k))
             for k in CUBE_STAGES + (STAGE_COMPUTE, STAGE_COPY_WRITE)}
    if not all(stage[k] > 0 for k in stage):
        raise AssertionError(f"the run recorded these stages: {totals}")
    info = cubes['info']
    clean_s = stage['synthobs: cube CLEAN']
    it_s = info['loop_iterations'] / clean_s
    chan_it_s = info['channel_iterations'] / clean_s
    print(f"  stages (stage_times, exclusive): RT device compute "
          f"{stage[STAGE_COMPUTE] * 1e3:.4f} ms, RT copy-out and FITS "
          f"writes {stage[STAGE_COPY_WRITE] * 1e3:.4f} ms; " + ', '.join(
              f"{k.replace('synthobs: ', '')} {stage[k] * 1e3:.4f} ms"
              for k in CUBE_STAGES) + f" [{smi}]")
    print(f"  cube CLEAN: {RRL_NCHAN} channels in {info['n_blocks']} "
          f"block(s) of {info['chan_block']} (CUBE_BLOCK_BYTES "
          f"{imaging.CUBE_BLOCK_BYTES} at {imaging.CUBE_PLANES} planes a "
          f"channel); {info['iterations']} iterations at most, "
          f"{info['loop_iterations']} iterations of the batched loop over "
          f"the blocks, {info['channel_iterations']} channel-iterations: "
          f"{it_s:.1f} loop iterations and {chan_it_s:.1f} "
          f"channel-iterations a second [{smi}]")
    print(f"  execute {wall_s:.4f} s in all; stage totals: " + ', '.join(
        f"{k} {v:.4f} s" for k, v in sorted(totals.items())) +
        f"; peak device memory {peak_gb:.3f} GB [{smi}]")

    # the products; the FITS cube against the cube in memory
    if not run.completed:
        raise AssertionError("the observed RRL run did not complete")
    for key in ('ms_clean', 'ms_noisy', 'clean_image'):
        if not os.path.isfile(run.products.get(key, '')):
            raise AssertionError(f"no {key} product")
    with np.load(run.products['ms_noisy']) as f:
        n_vis = f['vis_re'].shape
        if f['vis_re'].shape[0] != RRL_NCHAN:
            raise AssertionError(f"noisy visibilities {n_vis}")
    img, img_hdr = fitsio.read_fits(run.products['clean_image'])
    freqs = np.asarray(run.chan_freqs)
    cards = {k: img_hdr.get(k) for k in ('CTYPE3', 'CRPIX3', 'CRVAL3',
                                         'CDELT3', 'CUNIT3', 'BUNIT')}
    if img.shape != (RRL_NCHAN, SYNTHOBS_IMSIZE, SYNTHOBS_IMSIZE) or \
            cards != {'CTYPE3': 'FREQ', 'CRPIX3': 1.0,
                      'CRVAL3': float(freqs[0]),
                      'CDELT3': float(freqs[1] - freqs[0]),
                      'CUNIT3': 'Hz', 'BUNIT': 'Jy/beam'}:
        raise AssertionError(f"restored cube {img.shape}, cards {cards}")
    if not np.array_equal(img, cubes['restored'].cpu().numpy()):
        raise AssertionError("the FITS cube is not the restored cube")
    if not np.all(np.isfinite(img)) or not img.max() > 0:
        raise AssertionError("the restored cube is not finite and positive")
    peaks = img.reshape(RRL_NCHAN, -1).max(1)
    print(f"  {n_vis[0]} x {n_vis[1]} visibilities; restored cube "
          f"{img.shape} ({os.path.getsize(run.products['clean_image'])} "
          f"bytes) with its FREQ axis {cards}: equal to the cube in "
          f"memory; channel peaks {peaks.min():.6e}-{peaks.max():.6e} "
          f"Jy/beam (line centre {peaks[RRL_NCHAN // 2]:.6e}); beam "
          f"{img_hdr['BMAJ'] * 3600:.4f}\" x "
          f"{img_hdr['BMIN'] * 3600:.4f}\"")
    del img, cubes
    errs, clean8 = cube_card_vs_cpu(run, img_hdr, smi)
    del pline
    shutil.rmtree(dcy)
    torch.cuda.empty_cache()
    return launches, {'wall_s': wall_s, 'peak_gb': peak_gb,
                      'chan_block': info['chan_block'],
                      'iterations': info['iterations'],
                      'loop_iterations': info['loop_iterations'],
                      'channel_iterations': info['channel_iterations'],
                      'it_s': it_s, 'chan_it_s': chan_it_s,
                      'stages_ms': {k: stage[k] * 1e3 for k in CUBE_STAGES},
                      'errs': errs, 'clean8': clean8}


def cli_card_vs_cpu(run, smi):
    """The calibration functions on run 1's corrupted noisy set and the
    CLEAN model of its first imaging, on the card and on the CPU from the
    same inputs (phase 2h); two solves on the card bit-identical.  Returns
    the errors, the times and a solve on the card's inputs for
    :func:`stefcal_numbers`."""
    import torch
    from rajepy_tpu_torch import constants as cnsts
    from rajepy_tpu_torch.io import fits as fitsio
    from rajepy_tpu_torch.synthobs import calibration as cal
    from rajepy_tpu_torch.synthobs import imaging, observatories, sampler
    sky, sky_hdr = fitsio.read_fits(run.fits_flux)
    _, img_hdr = fitsio.read_fits(run.products['clean_image'])
    with np.load(run.products['ms_noisy']) as f:
        uvw, freqs = f['uvw'], f['freqs']
        noisy = f['vis_re'] + 1j * f['vis_im']
    mask, cell_as = synthobs_mask(sky_hdr, img_hdr, *sky.shape[-2:])
    cell = cell_as * cnsts.ARCSEC
    lam = cnsts.C / freqs
    us = (uvw[None, :, 0] / lam[:, None]).ravel()
    vs = (uvw[None, :, 1] / lam[:, None]).ravel()
    ant = observatories.read_antenna_config(
        observatories.cfg_file(*run.tscop))
    n_ant = ant['xyz'].shape[0]
    pairs = np.stack(np.triu_indices(n_ant, k=1), axis=1)
    n_t = uvw.shape[0] // pairs.shape[0]
    meta = cal.vis_metadata(n_t, pairs)
    n_sol = run.results['selfcal']['n_sol']

    # the first imaging's CLEAN model, on the card
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device='cuda')
    vis_g = torch.as_tensor(noisy, device='cuda')
    wb = imaging.briggs_weights(t(us), t(vs), t(np.ones_like(us)),
                                SYNTHOBS_IMSIZE, cell, robust=0.5)
    dirty, psf = imaging.grid_and_image(t(us), t(vs), vis_g.reshape(-1), wb,
                                        SYNTHOBS_IMSIZE, cell)
    thr = 3.0 * float(dirty.cpu().numpy()[mask == 0].std())
    mdl = imaging.hogbom_clean(dirty, psf, mask, niter=500,
                               threshold=thr)[0]
    mv = cal.model_vis(mdl, cell, us, vs).reshape(len(freqs), -1)
    c0 = SYNTHOBS_IMSIZE // 2
    h = CLI_DFT_PIX // 2
    cut = mdl[c0 - h:c0 + h, c0 - h:c0 + h]
    n = CLI_DFT_NVIS
    ws = uvw[:n, 2] / lam[0]
    print(f"  card vs CPU inputs: run 1's corrupted noisy set "
          f"{noisy.shape}, the CLEAN model of its first imaging "
          f"({int((mdl != 0).sum())} components, {float(mdl.sum()):.6e} "
          f"Jy), {n_sol} solution intervals of {n_t} time samples; the "
          f"DFTs on its {CLI_DFT_PIX}^2 centre ({float(cut.sum()):.6e} Jy) "
          f"at its first {n} channel-0 visibilities")
    calls = {
        'model_vis': lambda d, m, v, g: cal.model_vis(m, cell, us, vs),
        'solve_gains (phase)': lambda d, m, v, g: cal.solve_gains(
            v, g, *meta, n_ant=n_ant, n_t=n_t, n_sol=n_sol, mode='phase'),
        'solve_gains (amp+phase)': lambda d, m, v, g: cal.solve_gains(
            v, g, *meta, n_ant=n_ant, n_t=n_t, n_sol=n_sol,
            mode='amp+phase'),
        'solve_gains (per_channel)': lambda d, m, v, g: cal.solve_gains(
            v, g, *meta, n_ant=n_ant, n_t=n_t, n_sol=n_sol,
            per_channel=True),
        'correct_vis': lambda d, m, v, g: cal.correct_vis(
            v, cal.solve_gains(v, g, *meta, n_ant=n_ant, n_t=n_t,
                               n_sol=n_sol, mode='phase'), *meta, n_t),
        'closure_phases': lambda d, m, v, g: cal.closure_phases(
            v, n_ant, n_t),
        'log_closure_amplitudes': lambda d, m, v, g:
            cal.log_closure_amplitudes(v, n_ant, n_t),
        'sample_vis_dft': lambda d, m, v, g: sampler.sample_vis_dft(
            m[c0 - h:c0 + h, c0 - h:c0 + h], cell, us[:n], vs[:n]),
        'sample_vis_dft_w': lambda d, m, v, g: sampler.sample_vis_dft_w(
            m[c0 - h:c0 + h, c0 - h:c0 + h], cell, us[:n], vs[:n], ws),
    }

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    def real(x):
        return torch.view_as_real(x) if x.is_complex() else x

    errs, ms = {}, {}
    inputs = {'cuda': (mdl, vis_g, mv),
              'cpu': (mdl.cpu(), vis_g.cpu(), mv.cpu())}
    for name, fn in calls.items():
        out = {}
        for dev, (m, v, g) in inputs.items():
            fn(dev, m, v, g)              # warm
            out[dev], ms[name, dev] = timed(lambda: fn(dev, m, v, g))
        errs[name] = check(f"{name}, card vs CPU", real(out['cuda']).cpu(),
                           real(out['cpu']), SYNTHOBS_RTOL)[0]
        print(f"    {name}: card {ms[name, 'cuda']:.4f} ms, CPU "
              f"{ms[name, 'cpu']:.4f} ms (one warm call each, host clock) "
              f"[{smi}]")
    solve = calls['solve_gains (phase)']
    a, b = solve(*(('cuda',) + inputs['cuda'])), \
        solve(*(('cuda',) + inputs['cuda']))
    if not torch.equal(a, b):
        raise AssertionError("two solve_gains calls on the card differ")
    print("  two solve_gains calls on the card (phase, "
          f"{n_sol} intervals): bit-identical")
    return errs, {f"{name} {dev}": v for (name, dev), v in ms.items()}, \
        (f"phase, {n_sol} x {n_ant} x {n_ant}",
         lambda: solve(*(('cuda',) + inputs['cuda'])))


def stefcal_numbers(solve, smi):
    """One StEFCal solve of phase 2h under torch.profiler (run after the
    other phases' profiler sessions): its device operations, busy time
    and wall time."""
    what, fn = solve
    busy_ms, wall_ms, n_ops, top = device_busy(fn, n=3)
    warm_ms = cuda_ms(fn, n_rep=10, n_warm=1)
    print(f"  one StEFCal solve ({what}, 50 iterations) under "
          f"torch.profiler: {n_ops:g} device operations, device busy "
          f"{busy_ms:.4f} ms of {wall_ms:.4f} ms (idle share "
          f"{1.0 - busy_ms / wall_ms:.3f}); busiest: " + ', '.join(
              f"{k[:40]} {c}x {m:.4f} ms" for k, c, m in top[:3]) +
          f"; {warm_ms:.4f} ms a solve without the profiler (CUDA events, "
          f"median of 10) [{smi}]")
    return {'ops': n_ops, 'busy_ms': busy_ms, 'wall_ms': wall_ms,
            'ms': warm_ms}


def run_cli(log, tmp, smi):
    """The CLI with calibration and export, counted (phase 2h):
    ``rajepy_tpu_torch.main.main(['-rt', '-so', '-c', model, pipeline])``
    in this process on the flagship model file (512^3, ``dtype='auto'``)
    and the bundled campaign with its documented ``params['synthobs']``
    block and UVFITS export; every run's products and selfcal summary; run
    1's UVFITS files against its npz sets; the calibration functions card
    against CPU; a repeat of run 1 through ``reuse_vis``; run 2 with run
    1's gains transferred; and the no-argument dry run in a subprocess."""
    import glob
    import shutil
    import torch
    from rajepy_tpu_torch.main import main as cli
    from rajepy_tpu_torch.io import fits as fitsio
    from rajepy_tpu_torch.ops import kernels as kn
    from rajepy_tpu_torch.synthobs import observatories, uvfits
    from rajepy_tpu_torch.synthobs import simulate_observation
    from rajepy_tpu_torch.utils import profiling
    data = os.path.join(HERE, 'rajepy_tpu_torch', 'data')
    dcy = os.path.join(tmp, 'cli')
    mf = os.path.join(tmp, 'cli-model-params.py')
    pf = os.path.join(tmp, 'cli-pipeline-params.py')
    with open(os.path.join(data, 'example-model-params.py')) as f:
        text = f.read()
    with open(mf, 'w') as f:
        f.write(text + f"\nparams['grid'].update(n_x={N_GRID}, "
                f"n_y={N_GRID}, n_z={N_GRID}, l_z=None)\n")
    with open(os.path.join(data, 'example-pipeline-params.py')) as f:
        text = f.read()
    with open(pf, 'w') as f:
        f.write(text + f"\nparams['dcys']['model_dcy'] = {dcy!r}\n"
                f"params['synthobs'] = {CLI_SYNTHOBS!r}\n")
    print(f"phase 2h: the CLI, main(['-rt', '-so', '-c', model, pipeline]) "
          f"on the example jet at {N_GRID}^3 (dtype='auto') and the "
          f"bundled campaign with params['synthobs'] = {CLI_SYNTHOBS}")

    events = []
    record = profiling.record_stage

    def recording(name, seconds):
        events.append((name, seconds))
        record(name, seconds)

    profiling.record_stage = recording
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        profiling.collect_stage_times(True)
        kn.reset_launches()
        t_wall = time.perf_counter()
        pline = cli(['-rt', '-so', '-c', mf, pf])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t_wall
    finally:
        profiling.record_stage = record
    launches = read_launches('cli')
    totals = profiling.stage_times()
    profiling.collect_stage_times(False)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    runs = pline.runs
    if pline.model.dtype != torch.float32 or \
            pline.model.device.type != 'cuda' or \
            [r.obs_type for r in runs] != ['continuum'] * 6:
        raise AssertionError(f"the CLI built {pline.model.dtype} on "
                             f"{pline.model.device}, runs "
                             f"{[r.obs_type for r in runs]}")
    if launches['epoch_base_maps2_tiles'] != len(runs):
        raise AssertionError(f"the CLI must launch the dual-base epoch "
                             f"kernel once per run ({len(runs)}): "
                             f"{launches}")
    with open(pline.log.filename) as f:
        logged = f.read()
    figures = 'the pipeline\'s figures are skipped' not in logged
    print(f"  CLI wall time {wall_s:.4f} s for {len(runs)} runs; figures "
          f"{'drawn' if figures else 'skipped (no matplotlib)'}; peak "
          f"device memory {peak_gb:.3f} GB [{smi}]")

    # one line per run: its stages between two device-compute records
    per_run = []
    for name, seconds in events:
        if name == STAGE_COMPUTE:
            per_run.append({})
        if per_run:
            per_run[-1][name] = per_run[-1].get(name, 0.0) + seconds
    stage_ms = []
    for i, (run, st) in enumerate(zip(runs, per_run)):
        row = {k: 1e3 * sum(v for n, v in st.items() if n.startswith(k))
               for k in CLI_STAGES}
        row.update({f'mfs imaging{lab}': 1e3 * st.get(
            f'synthobs: mfs imaging ({SYNTHOBS_IMSIZE}px{lab})', 0.0)
            for lab in CLI_IMAGING})
        if not all(v > 0 for v in row.values()):
            raise AssertionError(f"run {i + 1} recorded these stages: {st}")
        stage_ms.append(row)
        print(f"  run {i + 1} ({run.year:g} yr): " + ', '.join(
            f"{k.replace('synthobs: ', '').strip()} {v:.4f} ms"
            for k, v in row.items()) + f" [{smi}]")
    print("  stage totals: " + ', '.join(
        f"{k} {v:.4f} s" for k, v in sorted(totals.items())))

    # every run's products and selfcal summary
    n_ant = observatories.read_antenna_config(
        observatories.cfg_file(*runs[0].tscop))['xyz'].shape[0]
    with np.load(runs[0].products['ms_noisy']) as f:
        n_t = f['uvw'].shape[0] // (n_ant * (n_ant - 1) // 2)
    n_sol = int(np.clip(round(runs[0].t_obs /
                              CLI_SYNTHOBS['selfcal_solint_s']), 1, n_t))
    for i, run in enumerate(runs):
        if not run.completed:
            raise AssertionError(f"run {i + 1} did not complete")
        for key in CLI_PRODUCTS:
            if not os.path.isfile(run.products.get(key, '')):
                raise AssertionError(f"run {i + 1}: no {key} product")
        sc = run.results['selfcal']
        drs = [sc['dynamic_range_before']] + sc['dynamic_range_rounds']
        if sc['n_sol'] != n_sol or sc['rounds'] != 2 or \
                sc['mode'] != 'phase' or not sc['gain_amp_rms'] < 1e-6 or \
                not all(np.isfinite(drs)) or len(drs) != 3:
            raise AssertionError(f"run {i + 1}: selfcal {sc}")
        with np.load(run.products['gains']) as f:
            g = f['g_re'] + 1j * f['g_im']
        if g.shape != (n_sol, n_ant) or \
                not np.allclose(np.abs(g), 1.0, atol=1e-12, rtol=0):
            raise AssertionError(f"run {i + 1}: gains {g.shape}, |g| "
                                 f"{np.abs(g).min()}-{np.abs(g).max()}")
        img, _ = fitsio.read_fits(run.products['clean_image'])
        if not np.all(np.isfinite(img)) or not img.max() > 0:
            raise AssertionError(f"run {i + 1}: restored image")
        print(f"  run {i + 1}: selfcal n_sol {sc['n_sol']}, rounds "
              f"{sc['rounds']}, gain amp rms {sc['gain_amp_rms']:.3e}, "
              f"phase rms {sc['gain_phase_rms_deg']:.4f} deg; dynamic "
              f"range {' -> '.join(f'{d:.4f}' for d in drs)}; imfit peak "
              f"{run.results['imfit']['Peak']['val']:.6e} "
              f"{run.results['imfit']['Peak']['unit']}")
    model_dcy = pline.dcy
    for name in (os.path.basename(mf), os.path.basename(pf)):
        if not os.path.isfile(os.path.join(model_dcy, name)):
            raise AssertionError(f"the CLI did not copy {name}")
    logs = glob.glob(os.path.join(model_dcy, 'ModelRun_*.log'))
    if len(logs) != 1:
        raise AssertionError(f"ModelRun logs in model_dcy: {logs}")
    print(f"  model_dcy holds the two param files and "
          f"{os.path.basename(logs[0])}")

    # run 1's UVFITS files against its npz sets (float32 in UVFITS)
    run = runs[0]
    for tag, key in (('uvfits_clean', 'ms_clean'),
                     ('uvfits_noisy', 'ms_noisy')):
        back = uvfits.read_uvfits(run.products[tag])
        with np.load(run.products[key]) as f:
            for part in ('vis_re', 'vis_im'):
                if not np.array_equal(back[part],
                                      f[part].astype(np.float32)):
                    raise AssertionError(f"{tag} {part} is not {key}'s "
                                         f"to float32 rounding")
        print(f"  {tag} ({os.path.getsize(run.products[tag])} bytes): "
              f"{back['vis_re'].shape} visibilities, {key}'s to float32 "
              f"rounding")

    errs, card_cpu_ms, solve = cli_card_vs_cpu(run, smi)

    # run 1 again through reuse_vis: the same gains and image, bit for bit
    kw = dict(CLI_SYNTHOBS, min_el=pline.params['min_el'])

    def gains_and_image():
        with np.load(run.products['gains']) as f:
            return [f['g_re'], f['g_im'],
                    fitsio.read_fits(run.products['clean_image'])[0]]

    first = gains_and_image()
    simulate_observation(pline, run, reuse_vis=True, **kw)
    if not all(np.array_equal(a, b) for a, b in
               zip(first, gains_and_image())):
        raise AssertionError("run 1 again through reuse_vis gave other "
                             "gains or another restored image")
    print("  run 1 again through reuse_vis: the same gains and restored "
          "image bit for bit")
    # run 2 with run 1's gains transferred
    t0 = time.perf_counter()
    prods = simulate_observation(pline, runs[1],
                                 applycal_gains=run.products['gains'], **kw)
    transfer_s = time.perf_counter() - t0
    with open(pline.log.filename) as f:
        if 'Applied transferred gain solutions from ' \
                f"{os.path.basename(run.products['gains'])}" not in f.read():
            raise AssertionError("run 2's gain transfer is not logged")
    if not os.path.isfile(prods['clean_image']):
        raise AssertionError("run 2 with transferred gains: no image")
    print(f"  run 2 with run 1's gains transferred: {transfer_s:.4f} s, "
          f"logged [{smi}]")

    # the no-argument dry run of the bundled files, in its own process
    home = os.path.join(tmp, 'home')
    os.makedirs(home)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, '-m', 'rajepy_tpu_torch.main'],
                         cwd=HERE, env=dict(os.environ, HOME=home),
                         capture_output=True, text=True, timeout=600)
    dry_s = time.perf_counter() - t0
    fits = glob.glob(os.path.join(home, '**', '*.fits'), recursive=True)
    if res.returncode != 0 or fits:
        raise AssertionError(f"python -m rajepy_tpu_torch.main: exit "
                             f"{res.returncode}, {len(fits)} FITS files; "
                             f"{res.stderr[-2000:]}")
    print(f"  python -m rajepy_tpu_torch.main (no arguments, the bundled "
          f"files' dry run on the card): exit 0 in {dry_s:.4f} s, no FITS "
          f"file [{smi}]")
    del pline
    shutil.rmtree(dcy)
    torch.cuda.empty_cache()
    return launches, {'wall_s': wall_s, 'peak_gb': peak_gb,
                      'stages_ms': stage_ms, 'card_cpu_ms': card_cpu_ms,
                      'transfer_s': transfer_s, 'dry_run_s': dry_s,
                      'errs': errs,
                      'selfcal': [r.results['selfcal'] for r in runs]}, \
        solve


def run_analysis(jm, smi):
    """Diagnostics and analysis, counted (phase 2g): the light curve of the
    flagship model over ANALYSIS_EPOCHS_YR and the 16 continuum channels
    (the single-base epoch kernel once per epoch), one of its epochs
    against the kernel's plain version and the channel stage on the same
    card tensors; every device reduction and analysis product timed on the
    flagship; each held on a ANALYSIS_CPU_GRID^3 model against the same
    call of a CPU model."""
    import torch
    from rajepy_tpu_torch import JetModel
    from rajepy_tpu_torch.models import analysis
    from rajepy_tpu_torch.ops import kernels as kn
    n_ep = len(ANALYSIS_EPOCHS_YR)
    print(f"phase 2g: diagnostics and analysis, {N_GRID}^3 float32: "
          f"light_curve over {n_ep} epochs ({ANALYSIS_EPOCHS_YR[0]:g}-"
          f"{ANALYSIS_EPOCHS_YR[-1]:g} yr) x {len(FREQS)} channels, the "
          f"device reductions, sed, spectral_index_map and turnover_map")
    jm.time = EPOCHS_YR[-1] * YEAR
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kn.reset_launches()
    curve, lc_ms = timed_once(lambda: analysis.light_curve(
        jm, ANALYSIS_EPOCHS_YR, FREQS))
    launches = read_launches('analysis')
    require_launched(launches, ('epoch_base_map_tiles',), 'analysis')
    if launches['epoch_base_map_tiles'] != n_ep:
        raise AssertionError(f"light_curve over {n_ep} epochs launched the "
                             f"single-base epoch kernel "
                             f"{launches['epoch_base_map_tiles']} times")
    if curve.shape != (n_ep, len(FREQS)) or \
            not np.all(np.isfinite(curve)) or not np.all(curve > 0):
        raise AssertionError(f"light curve {curve.shape}, finite and "
                             f"positive: {np.all(np.isfinite(curve))}, "
                             f"{np.all(curve > 0)}")
    thin = curve[:, -1]
    print(f"  light_curve: {lc_ms:.4f} ms (CUDA events, first call); at "
          f"{FREQS[-1]:.3e} Hz {thin.min():.6e} to {thin.max():.6e} Jy, at "
          f"{FREQS[0]:.3e} Hz {curve[:, 0].min():.6e} to "
          f"{curve[:, 0].max():.6e} Jy")
    # the brightest epoch against the plain version on the same tensors
    k = int(np.argmax(thin))
    st = jm._rt_static()
    t = float(ANALYSIS_EPOCHS_YR[k]) * YEAR
    a_map = kn.epoch_base_map_tiles_plain(st.a_t, st.tss_t, st.seg, t,
                                          jm._burst_tuple(), jm.nx, jm.nz,
                                          jm._ts_pack_offset)
    want = products_from_maps(jm, st, a_map, a_map)[2].sum(dim=(1, 2))
    check(f"light_curve epoch {k} ({ANALYSIS_EPOCHS_YR[k]:.4f} yr) vs "
          f"plain", torch.from_numpy(curve[k]).to(want), want, MAP_RTOL)
    del a_map, want

    calls = {
        'diagnostic_maps': lambda m: m.diagnostic_maps(),
        'occupancy_projections': lambda m: m.occupancy_projections(),
        'conservation_profiles': lambda m: m.conservation_profiles(),
        'velocity_midplane': lambda m: m.velocity_midplane(),
        'chi_xyz': lambda m: m.chi_xyz,
        'number_density': lambda m: m.number_density,
        'sed': lambda m: analysis.sed(m, FREQS),
        'spectral_index_map': lambda m: analysis.spectral_index_map(
            m, 1e9, 2e10, min_flux_jy=1e-12),
        'turnover_map': lambda m: analysis.turnover_map(m, FREQS),
        'light_curve': lambda m: analysis.light_curve(
            m, ANALYSIS_EPOCHS_YR, FREQS),
    }
    times_ms = {}
    for name, fn in calls.items():
        times_ms[name] = cuda_ms(lambda: fn(jm), n_rep=5, n_warm=1)
        print(f"  {name}: {times_ms[name]:.4f} ms (CUDA events, median of "
              f"5, the copy to the host included) [{smi}]")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  peak device memory {peak_gb:.3f} GB [{smi}]")

    # the card against the CPU, one float32 model on each
    n = ANALYSIS_CPU_GRID
    models = [JetModel(example_params((n,) * 3), dtype=torch.float32,
                       device=dev) for dev in ('cuda', 'cpu')]
    for m in models:
        m.time = EPOCHS_YR[-1] * YEAR
    errs = {}
    for name, fn in calls.items():
        got, want = (fn(m) for m in models)
        if isinstance(want, dict):
            got, want = ([d[key] for key in sorted(d)] for d in (got, want))
        elif isinstance(want, tuple):
            got, want = list(got), list(want)
        else:
            got, want = [got], [want]
        errs[name] = max(check_host(f"{name}, {n}^3 card vs CPU [{i}]", g,
                                    w, ANALYSIS_RTOL)[0]
                         for i, (g, w) in enumerate(zip(got, want)))
    del models
    torch.cuda.empty_cache()
    return launches, {'ms': times_ms, 'peak_gb': peak_gb, 'errs': errs,
                      'light_curve_first_ms': lc_ms}


def timed_adam(lr, events):
    """``optimizer=`` for a fit: the port's Adam recording a CUDA event
    after each step, so that the steps are timed on the card inside the
    fit (forward, backward and update)."""
    import torch
    from rajepy_tpu_torch.fit import Adam

    class TimedAdam(Adam):
        def step(self, closure=None):
            super().step(closure)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

    return lambda params: TimedAdam(params, lr=lr)


def step_ms(events):
    """Median milliseconds between consecutive steps' events."""
    import torch
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b)
                             for a, b in zip(events, events[1:]))


def sed_loss_grad(fwd, theta, observed):
    """The gradient of fit_sed's log-flux loss at ``theta``."""
    import torch
    th = torch.as_tensor(np.asarray(theta, np.float64)).requires_grad_(True)
    log_obs = torch.log(torch.as_tensor(np.asarray(observed, np.float64)))
    model = fwd(th)                 # the forward moves th to its device
    loss = torch.mean((torch.log(model) - log_obs.to(model.device)) ** 2)
    return torch.autograd.grad(loss, th)[0].cpu().numpy()


def start_model(jm, log, dtype='auto', device='cuda', n=None):
    """The flagship's parameters with mlr_bj and T_0 moved by FIT_START
    (the fits' start), on its grid or an n^3 one, at jm's epoch."""
    from rajepy_tpu_torch import JetModel
    p = example_params((jm.nx, jm.ny, jm.nz) if n is None else (n,) * 3)
    for key, f in FIT_START.items():
        p['properties'][key] *= f
    m = JetModel(p, log=log, dtype=dtype, device=device)
    m.time = jm.time
    return m


def fit_peak(fn):
    """(result, ms, (own GB, resident GB)) of one fit: CUDA events around
    it; the device memory resident just before it (what earlier phases
    left) and the fit's own peak above that."""
    import torch
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, ms = timed_once(fn)
    own = torch.cuda.max_memory_allocated() - resident
    return out, ms, (own / 1e9, resident / 1e9)


def peak_text(peak):
    own, resident = peak
    return f"peak memory {own:.3f} GB above {resident:.3f} GB resident"


def require_falls(res, what):
    loss = np.asarray(res.loss)
    if not (np.all(np.isfinite(loss)) and loss[-1] < loss[0]):
        raise AssertionError(f"{what}: the loss did not fall, or is not "
                             f"finite: {loss}")


def run_fits(jm, log, smi, uv1):
    """The fits on the card, counted (phase 2i): ``rajepy_tpu_torch.fit``
    at the flagship's width (the example jet at N_GRID^3, float32 model).

    a. ``fit_joint`` with one ``sed`` component (the 16 continuum
       channels), float32, mlr_bj and T_0 free, FIT_STEPS Adam steps from
       FIT_START; the step-0 gradient against float64 on the card;
    b. the same fit in float64 at FIT_CPU_GRID^3, card against CPU: loss
       history, final theta and step-0 gradient to FIT_CPU_RTOL;
    c. ``fit_light_curve`` over ANALYSIS_EPOCHS_YR x 16 channels, the four
       bursts' 12 parameters, FIT_STEPS steps;
    d. ``fit_rrl_spectrum`` (H58a, FIT_RRL_NCHAN channels across the
       line, float64 with remat), T_0 and v_lsr, FIT_SHORT_STEPS steps;
    e. ``fit_visibilities`` on phase 2e's run 1 uv tracks and first
       channel, float64, FIT_SHORT_STEPS steps; ``closure_uncertainties``
       on the first FIT_CLOSURE_NT integrations, float64 at
       FIT_CPU_GRID^3, card against CPU to FIT_CLOSURE_RTOL;
    f. ``laplace_uncertainties`` at a's end, theta as numpy and as a
       tensor on the card (FIT_SAME_RTOL), and a ``sweep`` of 8 combos.

    Each fit's steps are timed by CUDA events (median), with its own peak
    memory above what was resident before it; every loss must fall.  Of
    the hand-written kernels the fits launch the Faddeeva one alone (the
    RRL fit's Voigt profiles, whose derivative autograd takes from the
    Faddeeva ODE); their other forwards are plain torch (the other
    kernels have no backward)."""
    import torch
    from rajepy_tpu_torch import fit
    from rajepy_tpu_torch.ops import kernels as kn
    from rajepy_tpu_torch.ops import radtrans as rt
    print(f"phase 2i: fits, {N_GRID}^3 example jet (float32 model): "
          f"fit_joint (sed, {len(FREQS)} ch, float32, {FIT_STEPS} steps), "
          f"float64 at {FIT_CPU_GRID}^3 card vs CPU, fit_light_curve "
          f"({len(ANALYSIS_EPOCHS_YR)} epochs x {len(FREQS)} ch, "
          f"{FIT_STEPS} steps), fit_rrl_spectrum ({RRL_LINE}, "
          f"{FIT_RRL_NCHAN} ch, {FIT_SHORT_STEPS} steps), fit_visibilities "
          f"({uv1['cfg']}, {uv1['uvw'].shape[0]} visibilities, 1 ch, "
          f"{FIT_SHORT_STEPS} steps), closure_uncertainties, "
          f"laplace_uncertainties, sweep of 8")
    out = {}
    t_wall = time.perf_counter()
    kn.reset_launches()

    # a. the float32 SED fit of the flagship
    jm.time = EPOCHS_YR[-1] * YEAR
    truth, th_true = fit.build_sed_forward(jm, FREQS, FIT_FREE,
                                           dtype=torch.float32)
    with torch.no_grad():
        observed = truth(th_true).cpu().numpy()
    start = start_model(jm, log)
    comps = [{'kind': 'sed', 'freqs': FREQS, 'observed': observed}]
    ev = []
    res_a, ms_a, peak_a = fit_peak(lambda: fit.fit_joint(
        start, comps, free=FIT_FREE, steps=FIT_STEPS, dtype=torch.float32,
        optimizer=timed_adam(0.05, ev)))
    out['sed_f32_step_ms'] = step_ms(ev)
    out['sed_f32_peak_gb'], out['sed_f32_resident_gb'] = peak_a
    require_falls(res_a, 'the float32 SED fit')
    print(f"  a. float32 SED fit: {out['sed_f32_step_ms']:.4f} ms per step "
          f"(CUDA events, median of {FIT_STEPS - 1}), {ms_a:.1f} ms for the "
          f"fit; {peak_text(peak_a)}; loss {res_a.loss[0]:.6e} -> "
          f"{res_a.loss[-1]:.6e}; mlr_bj {res_a.values[FIT_FREE[0]]:.6e} "
          f"(truth {jm.params['properties']['mlr_bj']:.6e}), T_0 "
          f"{res_a.values[FIT_FREE[1]]:.6e} (truth "
          f"{jm.params['properties']['T_0']:.6e}) [{smi}]")
    f32, th0 = fit.build_sed_forward(start, FREQS, FIT_FREE,
                                     dtype=torch.float32)
    f64, _ = fit.build_sed_forward(start, FREQS, FIT_FREE)
    g32 = sed_loss_grad(f32, th0.cpu().numpy(), observed)
    g64, _, peak64 = fit_peak(
        lambda: sed_loss_grad(f64, th0.cpu().numpy(), observed))
    err = float(np.max(np.abs(g32 - g64)) / np.max(np.abs(g64)))
    out['grad_f32_vs_f64'] = err
    print(f"  a. step-0 gradient, float32 {g32} vs float64 {g64} on the "
          f"card: {err:.3e} of its largest component (float64 forward "
          f"and backward: {peak_text(peak64)})")
    if not err <= FIT_GRAD_RTOL:
        raise AssertionError(f"the float32 gradient is {err:.3e} off the "
                             f"float64 one")
    del f64
    torch.cuda.empty_cache()

    # f. the Laplace sigmas at a's end (theta as numpy, then as a tensor
    # on the card) and a sweep of 8 combos
    def laplace(theta):
        return fit.laplace_uncertainties(f32, theta, observed, FIT_FREE)

    (sig, cov), lap_ms = timed_once(lambda: laplace(res_a.theta))
    if not (np.all(np.isfinite(cov)) and all(v > 0 for v in sig.values())):
        raise AssertionError(f"laplace_uncertainties: {sig}, {cov}")
    sig_t, cov_t = laplace(torch.as_tensor(res_a.theta, device='cuda'))
    check_host("laplace_uncertainties, theta on the card vs numpy: cov",
               cov_t, cov, FIT_SAME_RTOL)
    check_host("laplace_uncertainties, theta on the card vs numpy: sigma",
               [sig_t[k] for k in FIT_FREE], [sig[k] for k in FIT_FREE],
               FIT_SAME_RTOL)
    out['laplace_ms'] = lap_ms
    print(f"  f. laplace_uncertainties at a's end: {lap_ms:.1f} ms (two "
          f"forward-mode products); sigma " + ', '.join(
              f"{k} {v:.6e}" for k, v in sig.items()))
    props = jm.params['properties']
    grid = {'properties.' + k: [props[k] * f for f in fs]
            for k, fs in FIT_SWEEP.items()}
    sw, sw_ms = timed_once(lambda: fit.sweep(jm, FREQS, grid,
                                             dtype=torch.float32))
    if sw.values.shape != (8, len(FREQS)) or \
            not np.all(np.isfinite(sw.values)) or np.any(sw.values <= 0):
        raise AssertionError(f"sweep: {sw.values.shape}, finite and "
                             f"positive {np.all(np.isfinite(sw.values))}")
    check_host("sweep combo at the truth vs the forward",
               sw.reshaped()[1, 0], observed, 1e-6)
    out['sweep_ms'] = sw_ms
    print(f"  f. sweep of 8 combos (mlr_bj x {FIT_SWEEP['mlr_bj']}, T_0 x "
          f"{FIT_SWEEP['T_0']}): {sw_ms:.1f} ms (CUDA events)")
    del start, f32, truth
    torch.cuda.empty_cache()

    # b. float64 at FIT_CPU_GRID^3: the card against the CPU
    n = FIT_CPU_GRID
    pair = [start_model(jm, log, torch.float64, d, n) for d in ('cuda',
                                                                 'cpu')]
    truth_s, th_s = fit.build_sed_forward(
        start_model(jm, log, torch.float64, 'cuda', n), FREQS, FIT_FREE)
    with torch.no_grad():
        obs_s = truth_s(th_s.cpu().numpy() - np.log(
            [FIT_START['mlr_bj'], FIT_START['T_0']])).cpu().numpy()
    comps_s = [{'kind': 'sed', 'freqs': FREQS, 'observed': obs_s}]
    res_b = [fit.fit_joint(m, comps_s, free=FIT_FREE, steps=FIT_STEPS)
             for m in pair]
    grads = []
    for m in pair:
        fwd, th = fit.build_sed_forward(m, FREQS, FIT_FREE)
        grads.append(sed_loss_grad(fwd, th.cpu().numpy(), obs_s))
    errs_b = {k: rel_err(torch.from_numpy(np.asarray(a)),
                         torch.from_numpy(np.asarray(b)))[0]
              for k, a, b in (('loss', res_b[0].loss, res_b[1].loss),
                              ('theta', res_b[0].theta, res_b[1].theta),
                              ('grad', *grads))}
    require_falls(res_b[0], f'the float64 {n}^3 SED fit')
    out['small_card_vs_cpu'] = errs_b
    print(f"  b. float64 {n}^3 SED fit, card vs CPU: " + ', '.join(
        f"{k} {v:.3e}" for k, v in errs_b.items()))
    if not max(errs_b.values()) <= FIT_CPU_RTOL:
        raise AssertionError(f"float64 fit, card vs CPU: {errs_b}")
    del pair, truth_s

    # c. the light curve: the four bursts' parameters
    times = ANALYSIS_EPOCHS_YR * YEAR
    lc, lc_th0, _ = fit.build_light_curve_forward(jm, times, FREQS)
    shift = np.tile([0.05, 0.1, -0.1], lc_th0.numel() // 3)
    with torch.no_grad():
        obs_c = lc(lc_th0.cpu().numpy() + shift).cpu().numpy()
    del lc
    ev = []
    res_c, ms_c, peak_c = fit_peak(lambda: fit.fit_light_curve(
        jm, times, FREQS, obs_c, steps=FIT_STEPS,
        optimizer=timed_adam(0.05, ev)))
    require_falls(res_c, 'the light-curve fit')
    out['lc_step_ms'] = step_ms(ev)
    out['lc_peak_gb'], out['lc_resident_gb'] = peak_c
    print(f"  c. light-curve fit ({len(times)} epochs x {len(FREQS)} ch, "
          f"{lc_th0.numel()} parameters): {out['lc_step_ms']:.4f} ms per "
          f"step (median of {FIT_STEPS - 1}), {ms_c:.1f} ms for the fit; "
          f"{peak_text(peak_c)}; loss {res_c.loss[0]:.6e} -> "
          f"{res_c.loss[-1]:.6e} [{smi}]")

    # d. the RRL spectrum, float64 with remat
    jm.time = RRL_EPOCH_YR * YEAR
    nu0 = rt.RRLCoeffs(RRL_LINE).nu0
    rfreqs = nu0 * (1.0 + np.linspace(-4e-4, 4e-4, FIT_RRL_NCHAN))
    rfree = ('properties.T_0', 'target.v_lsr')
    rrl, r_th0 = fit.build_rrl_spectrum_forward(jm, RRL_LINE, rfreqs, rfree)
    with torch.no_grad():
        obs_d = rrl(r_th0.cpu().numpy() + np.array([np.log(1.1), 5.0]))
        obs_d = obs_d.cpu().numpy()
    del rrl
    ev = []
    res_d, ms_d, peak_d = fit_peak(lambda: fit.fit_rrl_spectrum(
        jm, RRL_LINE, rfreqs, obs_d, free=rfree, steps=FIT_SHORT_STEPS,
        optimizer=timed_adam(0.05, ev)))
    require_falls(res_d, 'the RRL fit')
    out['rrl_step_ms'] = step_ms(ev)
    out['rrl_peak_gb'], out['rrl_resident_gb'] = peak_d
    print(f"  d. RRL fit ({RRL_LINE}, {FIT_RRL_NCHAN} ch, float64, remat): "
          f"{out['rrl_step_ms']:.4f} ms per step (median of "
          f"{FIT_SHORT_STEPS - 1}), {ms_d:.1f} ms for the fit; "
          f"{peak_text(peak_d)}; loss {res_d.loss[0]:.6e} -> "
          f"{res_d.loss[-1]:.6e} [{smi}]")
    torch.cuda.empty_cache()

    # e. visibilities on run 1's uv tracks, one channel, float64
    jm.time = uv1['time']
    vf, v_th = fit.build_vis_forward(jm, [uv1['freq']], uv1['uvw'],
                                     FIT_FREE)
    with torch.no_grad():
        obs_e = vf(v_th).cpu().numpy()
    del vf
    start = start_model(jm, log)
    ev = []
    res_e, ms_e, peak_e = fit_peak(lambda: fit.fit_visibilities(
        start, [uv1['freq']], uv1['uvw'], obs_e, free=FIT_FREE,
        steps=FIT_SHORT_STEPS, optimizer=timed_adam(0.05, ev)))
    require_falls(res_e, 'the visibility fit')
    out['vis_step_ms'] = step_ms(ev)
    out['vis_peak_gb'], out['vis_resident_gb'] = peak_e
    print(f"  e. visibility fit ({uv1['uvw'].shape[0]} visibilities at "
          f"{uv1['freq']:.4e} Hz, float64): {out['vis_step_ms']:.4f} ms per "
          f"step (median of {FIT_SHORT_STEPS - 1}), {ms_e:.1f} ms for the "
          f"fit; {peak_text(peak_e)}; loss {res_e.loss[0]:.6e} -> "
          f"{res_e.loss[-1]:.6e} [{smi}]")
    del start
    torch.cuda.empty_cache()

    # e. closure_uncertainties on run 1's first FIT_CLOSURE_NT
    # integrations, float64 at FIT_CPU_GRID^3: the card (theta a tensor
    # there) against the CPU (theta numpy)
    n_ant = uv1['n_ant']
    uvw_c = uv1['uvw'][:FIT_CLOSURE_NT * (n_ant * (n_ant - 1) // 2)]
    pair = [start_model(jm, log, torch.float64, d, FIT_CPU_GRID)
            for d in ('cuda', 'cpu')]
    cf, c_th = fit.build_vis_forward(pair[0], [uv1['freq']], uvw_c,
                                     FIT_FREE)
    with torch.no_grad():
        obs_cl = cf(c_th.cpu().numpy() - np.log(
            [FIT_START['mlr_bj'], FIT_START['T_0']])).cpu().numpy()
    del cf
    closure = [fit.closure_uncertainties(
        m, [uv1['freq']], uvw_c, obs_cl, th, FIT_FREE, n_ant=n_ant,
        n_t=FIT_CLOSURE_NT) for m, th in zip(pair, (c_th,
                                                    c_th.cpu().numpy()))]
    (sig_g, cov_g), (sig_c, cov_c) = closure
    if not (np.all(np.isfinite(cov_g)) and
            all(v > 0 for v in sig_g.values())):
        raise AssertionError(f"closure_uncertainties: {sig_g}, {cov_g}")
    errs_cl = {
        'cov': check_host("closure_uncertainties card vs CPU: cov", cov_g,
                          cov_c, FIT_CLOSURE_RTOL)[0],
        'sigma': check_host("closure_uncertainties card vs CPU: sigma",
                            [sig_g[k] for k in FIT_FREE],
                            [sig_c[k] for k in FIT_FREE],
                            FIT_CLOSURE_RTOL)[0]}
    out['closure_card_vs_cpu'] = errs_cl
    print(f"  e. closure_uncertainties ({uvw_c.shape[0]} visibilities, "
          f"{n_ant} antennas, {FIT_CLOSURE_NT} integrations, float64 "
          f"{FIT_CPU_GRID}^3), card vs CPU: cov {errs_cl['cov']:.3e}, "
          f"sigma {errs_cl['sigma']:.3e}; sigma " + ', '.join(
              f"{k} {v:.6e}" for k, v in sig_g.items()))
    del pair
    launches = read_launches('fit')
    if {k for k, v in launches.items() if v} != {'wofz'}:
        raise AssertionError(f"the fits launched hand-written kernels "
                             f"other than the Faddeeva one, or not it: "
                             f"{launches}")
    out['wall_s'] = time.perf_counter() - t_wall
    print(f"  the fits launched the Faddeeva kernel alone "
          f"({launches['wofz']} times; their other forwards are plain "
          f"torch); phase 2i took {out['wall_s']:.1f} s")
    torch.cuda.empty_cache()
    return launches, out


def same_bits(name, got, want):
    """Raise unless ``got`` equals ``want`` bit for bit (tensors or host
    arrays, or tuples of them)."""
    import torch
    if not isinstance(got, (tuple, list)):
        got, want = (got,), (want,)
    for g, w in zip(got, want, strict=True):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        if g.shape != w.shape or not np.array_equal(g, w):
            raise AssertionError(f"{name}: not bit for bit")
    print(f"  {name}: bit for bit")


def fanned_entries(log):
    return [str(e) for e in log.entries.values() if 'Fanned' in str(e)]


def run_parallel(jm, log, tmp, smi, core16, scan_args, clean8):
    """``rajepy_tpu_torch.parallel`` on the flagship, counted (phase 2j):
    every sharded function and the fan-out with meshes of PARALLEL_SHARDS
    shards on the one card, each against its single-device path; the
    pipeline with the device list replaced; the fits with ``mesh=``.
    Returns the parallel path's launches (every sharded call's, none of
    the references') and its numbers."""
    import contextlib
    import shutil
    import torch
    from rajepy_tpu_torch import Pipeline, fit
    from rajepy_tpu_torch.io import fits as fitsio
    from rajepy_tpu_torch.models import analysis
    from rajepy_tpu_torch.models import fields as mfields
    from rajepy_tpu_torch.models import grid as mgrid
    from rajepy_tpu_torch.ops import kernels as kn
    from rajepy_tpu_torch.ops import radtrans as rt
    from rajepy_tpu_torch.parallel import fanout, sharding
    card = jm._ensure_fields().ff.device
    shards = [card] * PARALLEL_SHARDS
    mesh22 = sharding.make_mesh(n_los=2, n_chan=2, devices=shards)
    mesh4 = sharding.make_mesh(n_los=1, n_chan=PARALLEL_SHARDS,
                               devices=shards)
    print(f"phase 2j: parallel, {N_GRID}^3 float32: meshes of "
          f"{PARALLEL_SHARDS} shards, all on the one card "
          f"({torch.cuda.get_device_name(0)}; the shards share it, so no "
          f"speed-up is measured and no copy between cards is made): "
          f"(n_chan, n_los) = (2, 2) for the LOS and channel functions, "
          f"{PARALLEL_SHARDS} along runs, epochs, starts and combos")
    launches = {k: 0 for k in kn.LAUNCHES}
    times = {}
    t_wall = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def counted(name, fn, parallel=True):
        """fn() with the counters reset just before it and read just after,
        added to the parallel path's unless it is a single-device
        reference; its time by the host clock."""
        torch.cuda.synchronize()
        kn.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        if parallel:
            for k, v in kn.LAUNCHES.items():
                launches[k] += v
        return out, dict(kn.LAUNCHES)

    def require(name, got, kernel, n):
        if got[kernel] != n:
            raise AssertionError(f"{name} launched {kernel} "
                                 f"{got[kernel]} times, not {n}")

    # the grid fill, LOS-sharded, and its per-shard memory
    jm.time = EPOCHS_YR[-1] * YEAR
    f = jm._ensure_fields()
    args = (jm._static_params(), jm._ss_jml_rb_frac, jm.nx, jm.ny, jm.nz,
            jm.csize)
    shard, _ = counted('sharded_static_fields', lambda: (
        sharding.sharded_static_fields(mesh22, *args, dtype=jm.dtype,
                                       with_time=jm._has_bursts)))
    same_bits("sharded_static_fields (2 LOS slabs) vs the model's fill",
              [getattr(shard, n).gather() for n in f._fields], list(f))
    stats = sharding.fill_memory_stats(mesh22, *args, dtype=jm.dtype,
                                       with_time=jm._has_bursts)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    whole = mfields.compute_static_fields(
        args[0], *mgrid.grid_corner_coords(jm.nx, jm.ny, jm.nz, jm.csize,
                                           jm.dtype, card), args[1],
        with_time=jm._has_bursts)
    torch.cuda.synchronize()
    whole_peak = torch.cuda.max_memory_allocated() - resident
    del whole
    if not stats['per_device_bytes'] < whole_peak:
        raise AssertionError(f"fill_memory_stats: a shard's fill peaked at "
                             f"{stats['per_device_bytes']} bytes, the whole "
                             f"fill at {whole_peak}")
    print(f"  fill_memory_stats: a LOS shard's fill peaks at "
          f"{stats['per_device_bytes']} bytes above what was resident, the "
          f"whole fill at {whole_peak} bytes; outputs "
          f"{stats['per_device_output_bytes']} of "
          f"{stats['full_output_bytes']} bytes a shard")

    # the continuum RT step on the slabs, against the single-device ops
    errs = {}
    t_0, reyn, csize, dist = jm._rt_constants()
    freqs = jm._freqs(FREQS)
    step = sharding.sharded_rt_products(mesh22, t_0, reyn, csize, dist)
    (em_s, tau_s, flux_s), _ = counted('sharded_rt_products', lambda: step(
        freqs, shard.nd, shard.xi, shard.temp, shard.ff, shard.area,
        shard.inside))
    del shard
    ds = rt.path_length_cm(f.ff, f.area, csize)
    tau_w = rt.tau_ff_maps(freqs, f.temp, f.nd * f.xi, ds, f.inside, t_0,
                           reyn)
    want = (rt.emission_measure_map(f.nd, f.xi, f.ff, f.area, csize),
            tau_w, rt.flux_ff_maps(freqs, tau_w,
                                   *rt.mean_temperature_map(f.temp,
                                                            f.inside),
                                   csize, dist))
    for name, g, w in zip(('EM', 'tau', 'flux'),
                          (em_s, tau_s.gather(), flux_s.gather()), want):
        errs[f'rt_products {name}'] = check(
            f"sharded_rt_products {name} ({len(FREQS)} ch) vs the "
            f"single-device ops", g, w, PARALLEL_RTOL)[0]
    del em_s, tau_s, flux_s, want, tau_w

    # RRL line opacity: K5 per shard against K5 on the whole grid
    jm.time = RRL_EPOCH_YR * YEAR
    coeffs = rt.RRLCoeffs(RRL_LINE)
    f, n_es, ds = jm._rt_inputs()
    fr16 = jm._freqs(core16)
    want = rt.tau_rrl_maps_fused(coeffs, fr16, f.temp, n_es, f.vy, ds,
                                 f.inside)
    got, n = counted('sharded_rrl_tau_maps', lambda: (
        sharding.sharded_rrl_tau_maps(mesh22, coeffs, fr16, f.temp, n_es,
                                      f.vy, ds, f.inside)))
    require('sharded_rrl_tau_maps', n, 'rrl_cube_pallas', PARALLEL_SHARDS)
    errs['rrl_tau_maps'] = check(
        f"sharded_rrl_tau_maps ({len(core16)} {RRL_LINE} ch) vs "
        f"tau_rrl_maps_fused on the whole grid", got.gather(), want,
        PARALLEL_RTOL)[0]
    del got, want, n_es, ds

    # the ordered scan, K8 per shard, composed through the monoid
    want = kn.transfer_scan_maps(*scan_args)
    got, n = counted('sharded_transfer_scan', lambda: (
        sharding.sharded_transfer_scan(mesh22, *scan_args)))
    require('sharded_transfer_scan', n, 'transfer_scan_pallas',
            PARALLEL_SHARDS)
    for name, g, w in zip(('I', 'tau_total'), got, want):
        errs[f'transfer_scan {name}'] = check(
            f"sharded_transfer_scan {name} vs transfer_scan_maps on the "
            f"whole cube", g, w, PARALLEL_SCAN_RTOL)[0]
    del got, want

    # the epoch tiles and the light curve
    jm.time = EPOCHS_YR[-1] * YEAR
    st = jm._rt_static()
    tile_args = (st.a_t, st.tss_t, st.seg, jm.time, jm._burst_tuple(),
                 jm.nx, jm.nz, jm._ts_pack_offset)
    want = kn.epoch_base_map_tiles(*tile_args, walk=st.walk)
    got, n = counted('sharded_epoch_base_map_tiles', lambda: (
        sharding.sharded_epoch_base_map_tiles(mesh22, *tile_args,
                                              walk=st.walk)))
    if not 1 <= n['epoch_base_map_tiles'] <= PARALLEL_SHARDS:
        raise AssertionError(f"sharded_epoch_base_map_tiles: {n}")
    same_bits(f"sharded_epoch_base_map_tiles ({n['epoch_base_map_tiles']} "
              f"shards with tiles) vs the K1 map", got, want)
    want = analysis.light_curve(jm, ANALYSIS_EPOCHS_YR, FREQS)
    got, n = counted('light_curve_sharded', lambda: (
        sharding.light_curve_sharded(jm, ANALYSIS_EPOCHS_YR, FREQS,
                                     mesh4)))
    require('light_curve_sharded', n, 'epoch_base_map_tiles',
            len(ANALYSIS_EPOCHS_YR))
    same_bits(f"light_curve_sharded ({len(ANALYSIS_EPOCHS_YR)} epochs over "
              f"{PARALLEL_SHARDS} shards) vs light_curve", got, want)

    # cube imaging, channel-sharded
    clean_args, rest_g, dirty_g = clean8
    (rest, dirty), _ = counted('sharded_clean_cube', lambda: (
        sharding.sharded_clean_cube(mesh22, *clean_args)))
    same_bits(f"sharded_clean_cube ({len(clean_args[1])} ch over 2 'chan' "
              f"shards) vs clean_cube", (rest.gather(), dirty.gather()),
              (rest_g, dirty_g))
    del rest, dirty, clean8, clean_args, rest_g, dirty_g

    # the run fan-out: phase 2d's six continuum runs, two H58a epochs
    params = Pipeline.py_to_dict(os.path.join(
        HERE, 'rajepy_tpu_torch', 'data', 'example-pipeline-params.py'))
    dcy = os.path.join(tmp, 'parallel')
    params['dcys']['model_dcy'] = dcy
    params['rrls']['times'] = np.array([])
    pline = Pipeline(jm, params, log=log)
    runs = pline.runs
    years = [r.year for r in runs]
    fmat = np.stack([np.atleast_1d(r.chan_freqs) for r in runs])
    seq = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for yr, fr in zip(years, fmat):
        jm.time = yr * YEAR
        seq.append(jm.continuum_rt_products(fr))
    times['6 continuum runs one by one'] = (time.perf_counter() - t0) * 1e3
    got, n = counted('continuum_runs_fanout (6 runs)', lambda: (
        fanout.continuum_runs_fanout(jm, years, fmat, mesh4)))
    require('continuum_runs_fanout', n, 'epoch_base_maps2_tiles', len(runs))
    same_bits(f"continuum_runs_fanout ({len(runs)} runs over "
              f"{PARALLEL_SHARDS} shards) vs continuum_rt_products",
              got, tuple(np.stack(p) for p in zip(*seq)))
    band = rrl_band(coeffs.nu0)[0]
    years2 = (RRL_EPOCH_YR, EPOCHS_YR[-1])
    for lte in (True, False):
        kind = 'LTE' if lte else 'non-LTE'
        b_pairs = None
        if not lte:
            b_pairs = []
            for yr in years2:
                jm.time = yr * YEAR
                b_pairs.append(jm.departure_coefficients(RRL_LINE))
        got, n = counted(f'rrl_runs_fanout ({kind}, 2 runs)', lambda: (
            fanout.rrl_runs_fanout(jm, RRL_LINE, years2, [band, band], mesh4,
                                   b_pairs=b_pairs)))
        require('rrl_runs_fanout', n, 'rrl_tiles_pallas', 2)
        for k, yr in enumerate(years2):
            jm.time = yr * YEAR
            same_bits(f"rrl_runs_fanout ({kind}, {RRL_NCHAN} ch) run "
                      f"{k + 1} vs rrl_rt_products",
                      tuple(a[k] for a in got),
                      jm.rrl_rt_products(RRL_LINE, band, lte=lte))
        del got
    del seq

    # the pipeline with the device list replaced
    @contextlib.contextmanager
    def replaced_devices():
        real = sharding.available_devices
        sharding.available_devices = lambda device: shards
        try:
            yield
        finally:
            sharding.available_devices = real

    quiet = dict(simobserve=False, verbose=False, plot=False)

    def stamps():
        return {p: os.stat(p).st_mtime_ns for r in pline.runs
                for p in (r.fits_em, r.fits_tau, r.fits_flux)
                if os.path.exists(p)}

    n_fanned = len(fanned_entries(log))
    with replaced_devices():
        _, n = counted('Pipeline.execute (fanned)',
                       lambda: pline.execute(**quiet))
        new = fanned_entries(log)[n_fanned:]
        if len(new) != 1 or f'Fanned {len(runs)} continuum runs' not in \
                new[0]:
            raise AssertionError(f"execute with {PARALLEL_SHARDS} shards "
                                 f"logged {new}")
        require('Pipeline.execute (fanned)', n, 'epoch_base_maps2_tiles',
                len(runs))
        for run, fr, yr in zip(runs, fmat, years):
            jm.time = yr * YEAR
            direct = jm.continuum_rt_products(fr)
            same_bits(f"fanned run {yr:g} yr: FITS EM, tau, flux vs the "
                      f"direct call", tuple(
                          fitsio.read_fits(p)[0] for p in
                          (run.fits_em, run.fits_tau, run.fits_flux)),
                      tuple(np.swapaxes(a, -1, -2) for a in direct))
        print(f"  execute: {new[0].split(':: ')[-1].strip()} [{smi}]")
        gone = (runs[1].fits_flux, runs[4].fits_flux)
        for p in gone:
            os.remove(p)
        before = stamps()
        n_fanned = len(fanned_entries(log))
        _, n = counted('Pipeline.execute (resumed, 2 pending)',
                       lambda: pline.execute(**quiet))
        new = fanned_entries(log)[n_fanned:]
        after = stamps()
        if len(new) != 1 or 'Fanned 2 continuum runs' not in new[0] or \
                n['epoch_base_maps2_tiles'] != 2 or \
                any(after[p] != before[p] for p in before) or \
                not all(p in after for p in gone):
            raise AssertionError(f"the resumed execute logged {new}, "
                                 f"launched {n} or rewrote finished runs")
        print(f"  resumed execute after two runs' flux FITS were deleted: "
              f"fanned and wrote those two alone")
        n_fanned = len(fanned_entries(log))
        _, n = counted('Pipeline.execute (device_fanout=False)',
                       lambda: pline.execute(clobber=True,
                                             device_fanout=False, **quiet),
                       parallel=False)
        if fanned_entries(log)[n_fanned:]:
            raise AssertionError("device_fanout=False fanned")
        require('Pipeline.execute (device_fanout=False)', n,
                'epoch_base_maps2_tiles', len(runs))
        print(f"  execute(device_fanout=False): one launch per run, no "
              f"fan-out")
    del pline
    shutil.rmtree(dcy)

    # the fits with mesh=
    jm.time = EPOCHS_YR[-1] * YEAR
    truth, th_true = fit.build_sed_forward(jm, FREQS, FIT_FREE,
                                           dtype=torch.float32)
    with torch.no_grad():
        observed = truth(th_true).cpu().numpy()
    start = start_model(jm, log, device=card)
    comps = [{'kind': 'sed', 'freqs': FREQS, 'observed': observed}]
    kw = dict(free=FIT_FREE, steps=FIT_SHORT_STEPS, dtype=torch.float32,
              n_starts=PARALLEL_SHARDS)
    res_m, _ = counted(f'fit_joint ({PARALLEL_SHARDS} starts, mesh)',
                       lambda: fit.fit_joint(start, comps, mesh=mesh4, **kw))
    res_n, _ = counted(f'fit_joint ({PARALLEL_SHARDS} starts, mesh=None)',
                       lambda: fit.fit_joint(start, comps, **kw),
                       parallel=False)
    same_bits(f"fit_joint SED fit, {PARALLEL_SHARDS} starts x "
              f"{FIT_SHORT_STEPS} steps, mesh vs mesh=None (theta, loss, "
              f"model)", (res_m.theta, res_m.loss, *res_m.model),
              (res_n.theta, res_n.loss, *res_n.model))
    del start, truth
    props = jm.params['properties']
    grid = {'properties.' + k: [props[k] * v for v in fs]
            for k, fs in FIT_SWEEP.items()}
    sw_n, _ = counted('sweep (8 combos, mesh=None)', lambda: fit.sweep(
        jm, FREQS, grid, dtype=torch.float32), parallel=False)
    for bs in (None, 3):
        sw_m, _ = counted(f'sweep (8 combos, mesh, batch_size {bs})',
                          lambda: fit.sweep(jm, FREQS, grid,
                                            dtype=torch.float32, mesh=mesh4,
                                            batch_size=bs))
        same_bits(f"sweep of 8 combos, mesh, batch_size {bs}, vs "
                  f"mesh=None", sw_m.values, sw_n.values)
    torch.cuda.empty_cache()

    require_launched(launches, PARALLEL_KERNELS, 'parallel')
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    wall_s = time.perf_counter() - t_wall
    print(f"  launches in the parallel runs: {launches}")
    print(f"  times (host clock around a synchronise, ms): " + ', '.join(
        f"{k} {v:.4f}" for k, v in times.items()) + f" [{smi}]")
    print(f"  six continuum runs fanned over {PARALLEL_SHARDS} shards on "
          f"one card {times['continuum_runs_fanout (6 runs)']:.4f} ms, one "
          f"by one {times['6 continuum runs one by one']:.4f} ms (both with "
          f"the copy-out); peak memory {peak_gb:.3f} GB; phase 2j "
          f"{wall_s:.1f} s [{smi}]")
    return launches, {'ms': times, 'errs': errs, 'peak_gb': peak_gb,
                      'wall_s': wall_s,
                      'fill_shard_bytes': stats['per_device_bytes'],
                      'fill_whole_bytes': whole_peak}


def report_lines(text):
    """An example's printed report without the lines of its pipeline's log
    (time-stamped entries and their run tables)."""
    import re
    stamp = re.compile(r'^\d{1,2}[A-Z]+\d{4}-\d\d:\d\d:\d\d::')
    return [line for line in text.splitlines()
            if not stamp.match(line) and not line.startswith(' ' * 20)]


def recovered(name, got, truth):
    """Raise unless each fitted value is within EXAMPLE_FIT_RTOL of the
    truth the example prints beside it."""
    for key, value in got.items():
        rel = abs(float(value) / truth[key] - 1.0)
        print(f"  {name} {key}: {float(value):.6g} against the truth "
              f"{truth[key]:g}, {rel:.3e} off (tolerance "
              f"{EXAMPLE_FIT_RTOL:g})")
        if not rel <= EXAMPLE_FIT_RTOL:
            raise AssertionError(f"{name}: {key} = {float(value):.6g} is "
                                 f"{rel:.3e} off the truth {truth[key]:g}")


@contextlib.contextmanager
def wrapped(module, names, wrap):
    """Replace each ``module.<name>`` by ``wrap(name, original)`` for the
    block (the port's modules call these functions through the module, so
    every call in the block goes through the wrapper)."""
    saved = {n: getattr(module, n) for n in names}
    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield saved
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def timing_calls(record):
    """A ``wrapped`` wrapper that appends (name, steps, seconds) of each
    call to ``record``: the call's wall time between two synchronisations
    of the card, and its ``steps`` keyword."""
    import torch

    def wrap(name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            record.append((name, kwargs.get('steps'),
                           time.perf_counter() - t0))
            return out
        return call
    return wrap


def copied(x):
    """``x`` with every tensor in it (in tuples, lists, dicts) cloned."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(copied(v) for v in x)
    if isinstance(x, dict):
        return {k: copied(v) for k, v in x.items()}
    return x


def first_calls(seen):
    """A ``wrapped`` wrapper that keeps copies of the arguments and the
    result of each wrapper's first call in ``seen[name]``; the kernel
    wrapper itself runs, and counts its launch, as always."""
    def wrap(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            if name not in seen:
                seen[name] = (copied(args), copied(kwargs), copied(out))
            return out
        return call
    return wrap


def hold_first_launches(example, seen, wrappers):
    """Each kernel's first launch in an example, held against its plain
    version on copies of the same card tensors (MAP_RTOL).  An epoch map
    launched for per-tile partials (no ``seg``: every tile its own
    position) gets the identity segment ids.  Returns the relative
    errors."""
    import inspect
    import torch
    from rajepy_tpu_torch.ops import kernels as kn
    errs = {}
    for name, (args, kwargs, out) in seen.items():
        bound_args = inspect.signature(wrappers[name]).bind(*args, **kwargs)
        bound_args.apply_defaults()
        a = dict(bound_args.arguments)
        a.pop('walk', None)
        if 'seg' in a and a['seg'] is None:
            tiles = a.get('base_t', a.get('a_t'))
            a['seg'] = torch.arange(tiles.shape[0], device=tiles.device)
        want = getattr(kn, EXAMPLE_PLAIN[name][1])(**a)
        got, want = ((out, want) if isinstance(out, tuple)
                     else ((out,), (want,)))
        errs[name] = max(check(
            f"{example} {name} first launch {tuple(g.shape)} vs its plain "
            f"version", g, w, MAP_RTOL)[0] for g, w in zip(got, want))
    return errs


def nonlte_f32_vs_f64(out, smi):
    """``nonlte_and_surveys``' H58a line-centre fluxes as the card ran them
    (float32, the RRL tile kernel) against the same calls on the card in
    float64 (the plain path) and in float32 through the kernel's plain
    version: the first reading is the precision's, the second the
    kernel's."""
    import inspect
    import torch
    from rajepy_tpu_torch import JetModel
    from rajepy_tpu_torch.examples import bundled_params, nonlte_and_surveys
    from rajepy_tpu_torch.ops import kernels as kn
    g = inspect.signature(nonlte_and_surveys.main).parameters['grid'].default
    p = bundled_params()
    p['grid'].update(n_x=g[0], n_y=g[1], n_z=g[2], l_z=None)
    freqs = out['freqs']

    def line_centre(dtype):
        jm = JetModel(copy.deepcopy(p), dtype=dtype, device='cuda')
        jm.time = 2.0 * YEAR
        s_lte = np.nansum(jm.flux_rrl('H58a', freqs), axis=(1, 2))[4]
        s_nl = np.nansum(jm.flux_rrl('H58a', freqs, lte=False),
                         axis=(1, 2))[4]
        maps = jm.departure_coefficient_maps('H58a')
        s_map = np.nansum(jm.flux_rrl('H58a', freqs, lte=False,
                                      departure_coeffs=maps), axis=(1, 2))[4]
        return {'lte': float(s_lte), 'nonlte': float(s_nl),
                'ratio': float(s_nl / s_lte), 'maps': float(s_map)}

    card = {'lte': float(out['s_lte'][4]), 'nonlte': float(out['s_nonlte'][4]),
            'ratio': float(out['ratio']), 'maps': float(out['s_map'][4])}
    f64 = line_centre(torch.float64)
    with wrapped(kn, ('rrl_tiles',), lambda n, fn: kn.rrl_tiles_plain):
        plain32 = line_centre(torch.float32)
    rel = {}
    for what, ref in (('f64', f64), ('plain32', plain32)):
        rel[what] = {k: abs(card[k] / ref[k] - 1.0) for k in card}
        print(f"  nonlte_and_surveys line centre, card float32 (kernel) "
              f"against the card in {what}: " + ', '.join(
                  f"{k} {card[k]:.6e} / {ref[k]:.6e} ({rel[what][k]:.3e} "
                  f"off)" for k in card) + f" [{smi}]")
    for k, v in rel['f64'].items():
        lim = NONLTE_MAPS_RTOL if k == 'maps' else NONLTE_F32_RTOL
        if not v <= lim:
            raise AssertionError(f"nonlte_and_surveys: float32 {k} "
                                 f"{v:.3e} off float64 (limit {lim:g})")
    for k, v in rel['plain32'].items():
        if not v <= MAP_RTOL:
            raise AssertionError(f"nonlte_and_surveys: {k} through the "
                                 f"kernel {v:.3e} off its plain version")
    return {'card': card, 'f64': f64, 'plain32': plain32, 'rel': rel}


def run_examples(tmp, smi):
    """The examples (``rajepy_tpu_torch.examples``) as shipped, counted
    (phase 2k): each ``main(device='cuda')`` at the JAX example's own
    sizes and step counts (but the cuts of EXAMPLE_KWARGS), in this
    process, with the launch counters reset just before it and read just
    after; its wall time, report, peak memory above what was resident and
    each fit's time per step; its checks, and each kernel's first launch
    in it against the kernel's plain version.  Then one example by
    ``python -m`` in its own process.  Returns each example's launches and
    the phase's numbers."""
    import importlib
    import io
    import torch
    from rajepy_tpu_torch import fit
    from rajepy_tpu_torch.models import analysis
    from rajepy_tpu_torch.ops import kernels as kn
    from rajepy_tpu_torch.ops import radtrans as rt
    from rajepy_tpu_torch.parallel import sharding
    card = sharding.available_devices('cuda')[0]
    print(f"phase 2k: the examples, each main(device='cuda') as shipped: "
          f"{', '.join(EXAMPLE_KERNELS)}; multi_chip_sharded over "
          f"{PARALLEL_SHARDS} shards of the one card [{smi}]")
    launches, numbers = {}, {}
    t_phase = time.perf_counter()

    def run(name, hold=True, **kw):
        mod = importlib.import_module(f'rajepy_tpu_torch.examples.{name}')
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fits, seen = [], {}
        kn.reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), \
                wrapped(fit, EXAMPLE_FITS, timing_calls(fits)), \
                wrapped(kn, EXAMPLE_PLAIN if hold else (),
                        first_calls(seen)) as kernel_wrappers:
            out = mod.main(device='cuda', **kw,
                           **EXAMPLE_KWARGS.get(name, {}))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = dict(kn.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() - resident
        launches[name] = counts
        numbers[name] = {'wall_s': wall_s, 'peak_gb': peak / 1e9,
                         'resident_gb': resident / 1e9,
                         'launches': {k: v for k, v in counts.items() if v}}
        print(f"  {name}: {wall_s:.4f} s, peak memory {peak / 1e9:.3f} GB "
              f"above {resident / 1e9:.3f} GB resident; launches "
              f"{numbers[name]['launches']} [{smi}]")
        for line in report_lines(buf.getvalue()):
            print(f"    | {line}")
        if fits:
            numbers[name]['fits'] = [
                {'fit': f, 'steps': n, 's': s,
                 'ms_per_step': s / n * 1e3 if n else None}
                for f, n, s in fits]
            print(f"  {name} fits (wall time of the call, card "
                  f"synchronised): " + ', '.join(
                      f"{f} {s:.4f} s" + (f" / {n} steps = "
                                          f"{s / n * 1e3:.4f} ms a step"
                                          if n else '')
                      for f, n, s in fits) + f" [{smi}]")
        require_launched(counts, EXAMPLE_KERNELS[name], f'example {name}')
        if hold:
            numbers[name]['held'] = hold_first_launches(name, seen,
                                                        kernel_wrappers)
            missing = set(EXAMPLE_KERNELS[name]) - {
                EXAMPLE_PLAIN[w][0] for w in seen}
            if missing:
                raise AssertionError(f"example {name}: no first launch of "
                                     f"{sorted(missing)} to hold")
        return out

    # the 512^3 production run: its SED, H58a cube and light curve against
    # the plain versions on the same model's card tensors
    out = run('single_chip_production', hold=False)
    m = out['model']
    sec = out['times']
    numbers['single_chip_production']['sections_s'] = sec
    print(f"  single_chip_production sections (host clock): " + ', '.join(
        f"{k} {v:.4f} s" for k, v in sec.items()) + f" [{smi}]")
    check_host("single_chip_production SED vs nansum(flux_ff) of the same "
               "model", out['sed'],
               np.nansum(m.flux_ff(out['freqs']), axis=(1, 2)),
               EXAMPLE_SED_RTOL)
    inputs, walk = rrl_tile_inputs(m, out['chans'])
    check(f"single_chip_production {RRL_LINE} tau cube "
          f"({len(out['chans'])} ch) vs the RRL tile kernel's plain version",
          torch.from_numpy(out['tau_cube']).to(card),
          kn.rrl_tiles_plain(*inputs, *walk), MAP_RTOL)
    del inputs, walk
    lc = out['light_curve']
    k = int(np.argmax(lc[:, 0]))
    st = m._rt_static()
    a_map = kn.epoch_base_map_tiles_plain(
        st.a_t, st.tss_t, st.seg, float(out['lc_years'][k]) * YEAR,
        m._burst_tuple(), m.nx, m.nz, m._ts_pack_offset)
    want = products_from_maps(m, st, a_map, a_map,
                              out['lc_freqs'])[2].sum(dim=(1, 2))
    check(f"single_chip_production light curve epoch {k} "
          f"({out['lc_years'][k]:.4f} yr) vs plain",
          torch.from_numpy(lc[k]).to(want), want, MAP_RTOL)
    del out, m, st, a_map, want

    # sharded over four shards of the card: the maps against the
    # single-device ops on the model's own fill (the sharded step takes the
    # static fields, with no burst factor), the epochs and the fanned runs
    # against the one-device calls bit for bit
    shards = [card] * PARALLEL_SHARDS
    available = sharding.available_devices
    sharding.available_devices = lambda device: shards
    try:
        out = run('multi_chip_sharded')
    finally:
        sharding.available_devices = available
    if out['mesh'] != {'chan': 2, 'los': PARALLEL_SHARDS // 2}:
        raise AssertionError(f"multi_chip_sharded: mesh {out['mesh']}")
    m = out['model']
    f = m._ensure_fields()
    t_0, reyn, csize, dist = m._rt_constants()
    freqs = m._freqs(out['freqs'])
    ds = rt.path_length_cm(f.ff, f.area, csize)
    taus = rt.tau_ff_maps(freqs, f.temp, f.nd * f.xi, ds, f.inside, t_0,
                          reyn)
    want = (rt.emission_measure_map(f.nd, f.xi, f.ff, f.area, csize), taus,
            rt.flux_ff_maps(freqs, taus, *rt.mean_temperature_map(
                f.temp, f.inside), csize, dist))
    for name, got, w in zip(('EM', 'tau', 'flux'),
                            (out['em'], out['taus'], out['fluxes']), want):
        check(f"multi_chip_sharded {name} maps ({PARALLEL_SHARDS} shards) vs "
              f"the single-device ops", got, w, PARALLEL_RTOL)
    same_bits("multi_chip_sharded light curve vs light_curve",
              out['light_curve'], analysis.light_curve(
                  m, out['lc_years'], out['freqs'][:2]))
    seq = []
    for yr, fr in zip(out['years'], out['freqs_mat']):
        m.time = yr * YEAR
        seq.append(m.continuum_rt_products(fr))
    same_bits(f"multi_chip_sharded fanned runs ({len(seq)}) vs "
              f"continuum_rt_products", out['fanned'],
              tuple(np.stack(p) for p in zip(*seq)))
    del out, m, f, ds, taus, want, seq

    out = run('nonlte_and_surveys')
    if not (np.all(np.isfinite(out['s_lte'])) and out['ratio'] > 1.0 and
            np.all(np.isfinite(out['alpha']))):
        raise AssertionError("nonlte_and_surveys: non-finite fluxes or a "
                             "non-LTE line weaker than the LTE one")
    numbers['nonlte_and_surveys']['line_centre'] = nonlte_f32_vs_f64(out,
                                                                     smi)
    del out

    out = run('fit_parameters')
    truth = out['truth']
    recovered('fit_parameters', {
        'properties.mlr_bj': out['sed'].values['properties.mlr_bj'],
        'properties.T_0': out['sed'].values['properties.T_0'],
        't_0': out['light_curve'].t_0[0], 'hl': out['light_curve'].hl[0],
        'chi': out['light_curve'].chi[0],
        'rrl.properties.T_0': out['rrl'].values['properties.T_0'],
        'rrl.target.v_lsr': out['rrl'].values['target.v_lsr']}, truth)
    for key in ('sed', 'light_curve', 'rrl'):
        require_falls(out[key], f"fit_parameters {key} fit")
    numbers['fit_parameters']['acceptance'] = float(
        out['posterior'].acceptance)
    del out

    out = run('calibration_workflow', out=os.path.join(tmp, 'example_cal'))
    dr = [out['dynamic_range_before']] + out['dynamic_range_rounds']
    if not all(b > a for a, b in zip(dr, dr[1:])):
        raise AssertionError(f"calibration_workflow: the dynamic range "
                             f"does not rise every round: {dr}")
    recovered('calibration_workflow', {'mlr_bj': out['mlr_bj']},
              {'mlr_bj': out['truth']})
    require_falls(out['closure'], "calibration_workflow closure fit")
    numbers['calibration_workflow']['dynamic_range'] = [float(d) for d in dr]
    del out

    out = run('uvfits_interchange', out=os.path.join(tmp, 'example_uvfits'))
    with np.load(out['products']['ms_noisy']) as d:
        written = d['vis_re'].shape
    if (out['n_chan'], out['n_vis']) != written or out['n_ant'] != 27:
        raise AssertionError(f"uvfits_interchange: read back "
                             f"{out['n_chan']} x {out['n_vis']} "
                             f"visibilities of {out['n_ant']} antennas, the "
                             f"run wrote {written}")
    print(f"  uvfits_interchange: the file reads back {out['n_chan']} x "
          f"{out['n_vis']} visibilities of {out['n_ant']} antennas, as the "
          f"run wrote them")
    numbers['uvfits_interchange'].update(
        fitted=float(out['fitted']),
        chi2=(float(out['chi2_first']), float(out['chi2_last'])))
    del out

    out = run('wide_field_vlbi')
    if not out['wstack_error'] < EXAMPLE_WSTACK_MAX < out['coplanar_error']:
        raise AssertionError(f"wide_field_vlbi: w-stacked error "
                             f"{out['wstack_error']:.3e}, coplanar "
                             f"{out['coplanar_error']:.3e} of the total flux")
    recovered('wide_field_vlbi', {'mlr_bj': out['mlr_bj']},
              {'mlr_bj': out['truth']})
    require_falls(out['fit'], "wide_field_vlbi visibility fit")
    numbers['wide_field_vlbi'].update(
        wstack_error=float(out['wstack_error']),
        coplanar_error=float(out['coplanar_error']))
    del out
    torch.cuda.empty_cache()

    # one example as a user runs it, in its own process
    home = os.path.join(tmp, 'home_examples')
    os.makedirs(home, exist_ok=True)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, '-m', f'rajepy_tpu_torch.examples.'
         f'{EXAMPLE_SUBPROCESS}'], cwd=HERE, env=dict(os.environ, HOME=home),
        capture_output=True, text=True, timeout=600)
    sub_s = time.perf_counter() - t0
    if res.returncode != 0 or not res.stdout.rstrip().endswith('OK'):
        raise AssertionError(f"python -m rajepy_tpu_torch.examples."
                             f"{EXAMPLE_SUBPROCESS}: exit {res.returncode}; "
                             f"{res.stderr[-2000:]}")
    print(f"  python -m rajepy_tpu_torch.examples.{EXAMPLE_SUBPROCESS}: "
          f"exit 0 in {sub_s:.4f} s [{smi}]")
    phase_s = time.perf_counter() - t_phase
    print(f"  phase 2k {phase_s:.1f} s [{smi}]")
    return launches, {'examples': numbers, 'subprocess_s': sub_s,
                      'wall_s': phase_s}


def check_emergent(jm, em):
    """Phase 2c's comparisons on the card: the main path against the plain
    versions, each kernel against its plain version at the main path's
    shapes (1e-5), the full-grid kernel against the tile kernel and the
    scan op against the full-grid kernel (2e-4)."""
    from rajepy_tpu_torch.ops import kernels as kn
    errs = {}
    k6, it, kt = emergent_tile_args(jm)
    got = jm._emergent_maps(FREQS)
    parts = kn.emergent_tile_partials_plain(*k6)
    want = kn.scatter_tile_maps(parts[0], it, kt, *jm._emergent_tiles()[8:],
                                jm.nx, jm.nz) * 1e-7 * 1e4
    check('flagship emergent maps vs plain', got, want, MAP_RTOL)
    k6_out = kn.emergent_tile_partials(*k6)
    errs['emergent_ff_tiles'] = max(
        check('emergent_ff_tiles I at main-path shape', k6_out[0], parts[0],
              KERNEL_RTOL),
        check('emergent_ff_tiles tau at main-path shape', k6_out[1],
              parts[1], KERNEL_RTOL))
    k6_maps = [kn.scatter_tile_maps(p, it, kt, *jm._emergent_tiles()[8:],
                                    jm.nx, jm.nz) for p in k6_out]
    del parts, k6_out, got, want

    k7 = emergent_full_args(jm)
    k7_out = kn.emergent_ff_full(*k7)
    want = kn.emergent_ff_full_plain(*k7)
    errs['emergent_ff_pallas'] = max(
        check(f'emergent_ff_pallas I, {N_GRID}^3 flagship cubes', k7_out[0],
              want[0], KERNEL_RTOL),
        check(f'emergent_ff_pallas tau, {N_GRID}^3 flagship cubes',
              k7_out[1], want[1], KERNEL_RTOL))
    del want
    check('emergent_ff_pallas I vs emergent_ff_tiles', k7_out[0],
          k6_maps[0], MAP_RTOL)
    check('emergent_ff_pallas tau vs emergent_ff_tiles', k7_out[1],
          k6_maps[1], MAP_RTOL)
    del k7, k6_maps

    c = em['c']
    err = []
    for near in (False, True):
        got = em['scan'] if not near else kn.transfer_scan_maps(
            *em['scan_args'], near)
        want = kn.transfer_scan_maps_plain(*em['scan_args'], near)
        for what, g, w in zip(('I', 'tau'), got, want):
            err.append(check(f'transfer_scan_pallas {what}, near_y0={near}, '
                             f'channel {c}', g, w, KERNEL_RTOL))
    errs['transfer_scan_pallas'] = max(err)
    check(f'transfer_scan_pallas I vs emergent_ff_pallas, channel {c}',
          em['scan'][0], k7_out[0][c], MAP_RTOL)
    check(f'transfer_scan_pallas tau vs emergent_ff_pallas, channel {c}',
          em['scan'][1], k7_out[1][c], MAP_RTOL)
    return errs


def emergent_numbers(jm, scan_c):
    """Phase 3 for the emergent path: the per-call time of the maps, the
    compaction, and the tile kernel and the scan op against their plain
    versions (plain, kernel, kernel, plain) and their bounds; returns the
    kernels' summary rows (the full-grid kernel's is
    :func:`full_grid_numbers`)."""
    import torch
    from rajepy_tpu_torch.ops import kernels as kn
    rows = []
    jm.time = EMERGENT_EPOCH_YR * YEAR
    tiles = jm._emergent_tiles()
    seg_len = np.diff(tiles[4].cpu().numpy())
    print(f"  emergent compaction (cubes flipped into observer order): "
          f"n_act = {tiles[0].shape[0]} tiles in n_seg = {tiles[7]} "
          f"segments of 1 to {seg_len.max()} tiles; the tile kernel "
          f"runs {tiles[7] * 1024} columns per block of "
          f"{kn.EMERGENT_CPT_TILES} channels")
    em_ms = cuda_ms(lambda: jm._emergent_maps(FREQS))
    t0 = time.perf_counter()
    for _ in range(10):
        jm.emergent_intensity_ff(FREQS)
    em_host_ms = (time.perf_counter() - t0) / 10 * 1e3
    print(f"  emergent_intensity_ff warm ({len(FREQS)} ch): {em_ms:.4f} "
          f"ms per call (CUDA events, median of 30, device tensors "
          f"out); {em_host_ms:.4f} ms per call with the numpy copy-out "
          f"(host clock, mean of 10)")
    print_busy('emergent_intensity_ff calls',
               lambda: jm._emergent_maps(FREQS), 10)
    k6, _, _ = emergent_tile_args(jm)
    k8 = scan_channel_args(jm, scan_c)
    rows = emergent_tile_numbers(jm, k6, tiles)
    kfn = lambda: kn.transfer_scan_maps(*k8)
    pfn = lambda: kn.transfer_scan_maps_plain(*k8)
    n_b = nbytes(*k8) + 2 * 4 * jm.nx * jm.nz
    n_ops = k8[0].numel() * SCAN_OPS
    p1 = cuda_ms(pfn, n_rep=5, n_warm=1)
    k1 = cuda_ms(kfn, batch=10)
    dev = kernel_ms(kfn)
    k2 = cuda_ms(kfn, batch=10)
    p2 = cuda_ms(pfn, n_rep=5, n_warm=0)
    b_ms, b_by = bound(n_b, n_ops)
    print(f"  transfer_scan_pallas: device {dev:.4f} ms (profiler, mean of "
          f"10); CUDA events {k1:.4f} / {k2:.4f} ms (median of 30 batches "
          f"of 10), plain {p1:.4f} / {p2:.4f} ms (median of 5); bound "
          f"{b_ms:.4f} ms by {b_by} ({n_b} B, {n_ops} ops), "
          f"{b_ms / dev:.3f} of it")
    rows.append(('transfer_scan_pallas', dev, p1, b_ms, b_by))
    return rows


def epoch_tile_numbers(jm, bursts, smi):
    """Phase 3 for the epoch tile kernel at the flagship: ptxas's report of
    both instantiations (one base, K1; two, K2; no spill allowed), two
    calls of each bit-identical, the device operations of each map call
    against those of the per-tile partials and folds it replaced (K1 must
    be one), and each (plain, kernel, kernel, plain) beside its bound: the
    bases read whole, the launch times only where a base is non-zero, the
    maps written once.  Returns the summary rows."""
    import torch
    from rajepy_tpu_torch.ops import kernels as kn
    print_ptxas(kn.build_log(), r'epoch_maps_kernelILi[12]E',
                {'epoch_maps_kernelILi1E', 'epoch_maps_kernelILi2E'})
    fixed, body, per_cell = chi_instructions(
        sass_functions(kn.library_path()), bursts)
    print(f"  burst_chi SASS (burst_chi_probe_kernel): {fixed} instructions "
          f"a cell plus {body} a burst of the cell's side: {per_cell} for "
          f"the bundled jet's sides (every burst, both sides: "
          f"{fixed + body * len(bursts)})")
    st = jm._rt_static()
    t, off = jm.time, jm._ts_pack_offset
    nx, nz = jm.nx, jm.nz
    k1 = lambda: kn.epoch_base_map_tiles(st.a_t, st.tss_t, st.seg, t, bursts,
                                         nx, nz, off, walk=st.walk)
    k2 = lambda: kn.epoch_base_maps2_tiles(st.a_t, st.em_t, st.tss_t, st.seg,
                                           t, bursts, nx, nz, off,
                                           walk=st.walk)
    first, second = k2(), k2()
    if not all(torch.equal(g, h) for g, h in zip(first, second)) or \
            not torch.equal(k1(), k1()):
        raise AssertionError("two calls of an epoch tile kernel at the "
                             "flagship gave different bits")

    # the per-tile partials (the same kernel, each tile its own position)
    # and the folds that each map call replaced
    def replaced1():
        return kn.reassemble_tiles(
            kn.epoch_tile_partials(st.a_t, st.tss_t, t, bursts, off), st.seg,
            nx, nz)

    def replaced2():
        return [kn.reassemble_tiles(p, st.seg, nx, nz) for p in
                kn.epoch_tile_partials2(st.a_t, st.em_t, st.tss_t, t, bursts,
                                        off)]

    n_epoch = device_ops(lambda: jm.continuum_rt_products(FREQS,
                                                          as_numpy=False))
    print(f"  epoch tile kernels: two calls bit-identical; a continuum "
          f"epoch ({len(FREQS)} ch) {n_epoch} device operations")
    for name, new, old, n_folds in (
            ('epoch_base_map_tiles', k1, replaced1, 'one index_add_ fold'),
            ('epoch_base_maps2_tiles', k2, replaced2,
             'two index_add_ folds')):
        n_new, n_old = device_ops(new), device_ops(old)
        print(f"  {name}: {n_new} device operation(s) per call, against "
              f"{n_old} for the per-tile partials and {n_folds} it "
              f"replaced (torch.profiler)")
        if name == 'epoch_base_map_tiles' and n_new != 1:
            raise AssertionError(f"{name}: {n_new} device operations a map")
    live1 = int(torch.count_nonzero(st.a_t))
    live2 = int(torch.count_nonzero((st.a_t != 0) | (st.em_t != 0)))
    n_map = nx * nz
    work = {   # kernel, plain, bytes, operations
        'epoch_base_map_tiles': (
            k1,
            lambda: kn.epoch_base_map_tiles_plain(st.a_t, st.tss_t, st.seg, t,
                                                  bursts, nx, nz, off),
            nbytes(st.a_t) + 4 * live1 + 4 * n_map,
            st.a_t.numel() + live1 * (7 + 6 * len(bursts))),
        'epoch_base_maps2_tiles': (
            k2,
            lambda: kn.epoch_base_maps2_tiles_plain(
                st.a_t, st.em_t, st.tss_t, st.seg, t, bursts, nx, nz, off),
            nbytes(st.a_t, st.em_t) + 4 * live2 + 2 * 4 * n_map,
            2 * st.a_t.numel() + live2 * (9 + 6 * len(bursts))),
    }
    rows = []
    for name, (kfn, pfn, n_b, n_ops) in work.items():
        p1, c1 = cuda_ms(pfn, batch=20), cuda_ms(kfn, batch=20)
        dev = kernel_ms(kfn)
        c2, p2 = cuda_ms(kfn, batch=20), cuda_ms(pfn, batch=20)
        b_ms, b_by = bound(n_b, n_ops)
        print(f"  {name}: device {dev:.4f} ms (profiler, mean of 10); CUDA "
              f"events {c1:.4f} / {c2:.4f} ms per call, plain {p1:.4f} / "
              f"{p2:.4f} ms (median of 30 batches of 20); bound {b_ms:.4f} "
              f"ms by {b_by} ({n_b} B, {n_ops} ops), {b_ms / dev:.3f} of it "
              f"[{smi}]")
        rows.append((name, dev, p1, b_ms, b_by))
    print(f"  the launch time is read at {live1} cells (a != 0) by "
          f"epoch_base_map_tiles of a, at {live2} (a or em != 0) by "
          f"epoch_base_maps2_tiles, of {st.a_t.numel()}")
    return rows


def device_ops(fn, n=10):
    """Device operations (kernels, copies, memsets) per call of ``fn``, by
    ``torch.profiler`` over ``n`` warm calls, rounded (the profiler may
    drop an event)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    count = sum(e.device_type == torch.autograd.DeviceType.CUDA
                for e in prof.events())
    return round(count / n)


def emergent_tile_numbers(jm, k6, tiles):
    """Phase 3 for the emergent tile kernel at the flagship: ptxas's report
    (no spill allowed), its SASS (instructions and MUFU of the per-cell
    loop), and the kernel at 16 channels (plain, kernel, kernel, plain) and
    at 1, 5 and 64, each beside its bound: a read whole, tss and temp where
    a != 0, the maps once; the float32 operations of EMERGENT_OPS_*; and
    the special-function (MUFU) work of the kernel's cheapest path, one
    MUFU.EX2 per burst of the cell's side and a reciprocal per jet cell,
    a reciprocal and an exponential per jet cell and channel, at the SMs'
    16 a clock.  Returns the summary row (16 channels)."""
    import torch
    from rajepy_tpu_torch.ops import kernels as kn
    print_ptxas(kn.build_log(), r'emergent_tiles_kernel',
                {'emergent_tiles_kernel'})
    code = sass_kernel(sass_functions(kn.library_path()),
                       'emergent_tiles_kernel')
    loops = sass_loops(code)
    inner = max(loops[:-1], key=lambda lp: lp[3])
    print(f"  emergent_tiles_kernel SASS: {len(code)} instructions; its "
          f"per-cell loop (4 channels; series and expm1f paths both in the "
          f"count) {inner[2]} instructions, {inner[3]} MUFU")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = float(subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.max.sm',
         '--format=csv,noheader,nounits'], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]) * 1e6
    a_t, tss_t = k6[4], k6[5]
    live = a_t != 0
    n_live = int(torch.count_nonzero(live))
    n_red = int(torch.count_nonzero(live & (tss_t < 0)))
    bursts = k6[8]
    side_bursts = (n_red * sum(1 for b in bursts if b[3]) +
                   (n_live - n_red) * sum(1 for b in bursts if not b[3]))
    n_seg = tiles[7]
    row = None
    for n_chan in (16, 1, 5, 64):
        chan = jm._emergent_channels(jm._freqs(np.geomspace(3e8, 3e11,
                                                            n_chan)))
        args = (*chan, *k6[3:])
        kfn = lambda: kn.emergent_tile_partials(*args)
        pfn = lambda: kn.emergent_tile_partials_plain(*args)
        n_b = (nbytes(a_t, *chan, k6[6]) + 2 * 4 * n_live +
               2 * 4 * n_seg * n_chan * 1024)
        n_ops = (a_t.numel() - n_live) + n_live * (
            EMERGENT_OPS_CHI + EMERGENT_OPS_BURST * len(bursts) +
            EMERGENT_OPS_CHAN * n_chan)
        mufu = side_bursts + n_live * (1 + 2 * n_chan)
        mufu_ms = mufu / (sms * 16 * clock) * 1e3
        b_ms, b_by = bound(n_b, n_ops)
        if mufu_ms > b_ms:
            b_ms, b_by = mufu_ms, 'operations'
        plain = ''
        if n_chan == 16:
            p1 = cuda_ms(pfn, n_rep=5, n_warm=1)
        k1 = cuda_ms(kfn, batch=20)
        dev = kernel_ms(kfn)
        k2 = cuda_ms(kfn, batch=20)
        if n_chan == 16:
            p2 = cuda_ms(pfn, n_rep=5, n_warm=0)
            plain = f", plain {p1:.4f} / {p2:.4f} ms (median of 5)"
            row = ('emergent_ff_tiles', dev, p1, b_ms, b_by)
        print(f"  emergent_ff_tiles, {n_chan} ch: device {dev:.4f} ms "
              f"(profiler, mean of 10); CUDA events {k1:.4f} / {k2:.4f} ms "
              f"(median of 30 batches of 20){plain}; bound {b_ms:.4f} ms by "
              f"{b_by} ({n_b} B, {n_ops} ops; {mufu} MUFU at {sms} SMs x 16 "
              f"a clock at {clock / 1e6:g} MHz: {mufu_ms:.4f} ms), "
              f"{b_ms / dev:.3f} of it")
    return [row]


def epoch_full_work(base, n_bursts):
    """((bytes, operations) the full-grid epoch kernel must spend on this
    base cube, the same with both cubes read whole): base once, the map
    once, a packed launch time and a chi (5 + 6 per burst operations) only
    where base != 0, a test per cell; against a launch time and a chi at
    every cell."""
    import torch
    live = int(torch.count_nonzero(base))
    n_map = base.shape[0] * base.shape[2]
    per_cell = 5 + 6 * n_bursts
    return ((4 * (base.numel() + live + n_map),
             base.numel() + live * per_cell),
            (4 * (2 * base.numel() + n_map), base.numel() * per_cell))


def full_grid_numbers(jm, empty, bursts):
    """Phase 3 for the two kernels that stream base through the
    shared-memory ring: ptxas's report (no spill allowed), and each kernel
    on the flagship's cubes, on the jet-free grid (exact zeros), on a
    wholly jet cube (epoch) and at 64 channels (emergent): kernel, plain
    (one call), kernel, the device time by the profiler, and the bound.
    Returns the two kernels' summary rows (the flagship's cubes at 16
    channels) and each kernel's largest (rel, abs) error against its plain
    version over these cases."""
    import torch
    from rajepy_tpu_torch.ops import kernels as kn
    print_ptxas(kn.build_log(), r'(?:epoch|emergent)_full_kernel',
                {'epoch_full_kernel', 'emergent_full_kernel'})
    jm.time = empty.time = EMERGENT_EPOCH_YR * YEAR
    errs, rows = {}, []

    def run(name, what, kfn, pfn, n_b, n_ops, zero, note=''):
        got = kfn()
        want, p_ms = timed_once(pfn)
        parts = ('I', 'tau') if len(got) == 2 else ('map',)
        err = [check(f'{name} {part} ({what})', g, w, KERNEL_RTOL)
               for part, g, w in zip(parts, got, want)]
        if zero and any(int(torch.count_nonzero(m)) for m in (*got, *want)):
            raise AssertionError(f"{name}: the jet-free grid gave non-zero "
                                 f"maps")
        del got, want
        errs[name] = max(err + [errs.get(name, (0.0, 0.0))])
        k1 = cuda_ms(kfn, batch=20)
        dev = kernel_ms(kfn)
        k2 = cuda_ms(kfn, batch=20)
        b_ms, b_by = bound(n_b, n_ops)
        print(f"  {name} ({what}): kernel {k1:.4f} / {k2:.4f} ms (median of "
              f"30 batches of 20), device {dev:.4f} ms (profiler, mean of "
              f"10), plain {p_ms:.4f} ms (one call); bound {b_ms:.4f} ms by "
              f"{b_by} ({n_b} B, {n_ops} ops), {b_ms / k1:.3f} of it{note}")
        if what.startswith('flagship cubes') and '64' not in what:
            rows.append((name, dev, p_ms, b_ms, b_by))

    t = jm.time
    st, st0 = jm._rt_static(), empty._rt_static()
    gen = torch.Generator(device=st.a.device).manual_seed(0)
    dense = (0.5 + torch.rand(st.a.shape, generator=gen,
                              device=st.a.device)) * st.a.max()
    for what, a, tss, off in (
            ('flagship cubes', st.a, st.ts_signed, jm._ts_pack_offset),
            ('jet-free grid', st0.a, st0.ts_signed, empty._ts_pack_offset),
            ('wholly jet cube', dense, st.ts_signed, jm._ts_pack_offset)):
        (n_b, n_ops), whole = epoch_full_work(a, len(bursts))
        w_ms, w_by = bound(*whole)
        run('epoch_base_map_full', what,
            lambda: (kn.epoch_base_map_full(a, tss, t, bursts, off),),
            lambda: (kn.epoch_base_map_full_plain(a, tss, t, bursts, off),),
            n_b, n_ops, what == 'jet-free grid',
            f"; with both cubes read whole the bound is {w_ms:.4f} ms by "
            f"{w_by} ({whole[0]} B, {whole[1]} ops)")
    del dense

    cnu, hnuk, scale, safe_t, base = emergent_full_args(jm)
    free_t, free_base = emergent_full_args(empty)[3:]
    chan64 = jm._emergent_channels(jm._freqs(np.geomspace(3e8, 3e11, 64)))
    for what, chan, temp, b in (
            ('flagship cubes, 16 ch', (cnu, hnuk, scale), safe_t, base),
            ('jet-free grid, 16 ch', (cnu, hnuk, scale), free_t, free_base),
            ('flagship cubes, 64 ch', chan64, safe_t, base)):
        n_chan = chan[0].numel()
        live = int(torch.count_nonzero(b))
        run('emergent_ff_pallas', what,
            lambda: kn.emergent_ff_full(*chan, temp, b),
            lambda: kn.emergent_ff_full_plain(*chan, temp, b),
            nbytes(b, *chan) + 4 * live + 2 * 4 * n_chan * jm.nx * jm.nz,
            b.numel() + live * EMERGENT_OPS_CHAN * n_chan,
            what.startswith('jet-free'))
    return rows, errs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from rajepy_tpu_torch import JetModel, Log
    from rajepy_tpu_torch.ops import kernels as kn

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    t_script = time.perf_counter()
    try:
        import matplotlib
        plot = True
        print(f"matplotlib {matplotlib.__version__}: phase 2e draws the "
              f"figures of execute(plot=True)")
    except ImportError:
        plot = False
        print("matplotlib cannot be imported: phase 2e runs "
              "execute(plot=False) and skips the figures")

    with tempfile.TemporaryDirectory() as tmp:
        log = Log(os.path.join(tmp, 'smoke.log'), verbose=False)
        jm = JetModel(example_params((N_GRID,) * 3), log=log, dtype='auto',
                      device='cuda')
        if jm.dtype != torch.float32:
            raise AssertionError(f"dtype='auto' on CUDA gave {jm.dtype}")
        bursts = jm._burst_tuple()
        phase_kernels(bursts)

        # ---------------- phase 2: the main paths, counted -------------- #
        empty = JetModel(example_params((N_GRID,) * 3, csize=1e-3),
                         log=log, dtype='auto', device='cuda')
        cont_launches, cont = run_continuum(jm, empty, tmp)
        launches = dict(cont_launches)
        rrl_launches, rrl = run_rrl(jm, empty, tmp)
        launches.update({k: rrl_launches[k] for k in RRL_KERNELS})
        em_launches, em = run_emergent(jm, empty)
        launches.update({k: em_launches[k] for k in EMERGENT_KERNELS})
        by_path = {'continuum': cont_launches, 'rrl': rrl_launches,
                   'emergent': em_launches,
                   'pipeline': run_pipeline(jm, log, tmp, smi)}
        by_path['synthobs'], synthobs = run_synthobs(jm, log, tmp, smi,
                                                     plot)
        by_path['cube'], cube = run_cube_observation(jm, log, tmp, smi)
        by_path['analysis'], ana = run_analysis(jm, smi)
        by_path['cli'], cli, cli_solve = run_cli(log, tmp, smi)
        by_path['fit'], fits = run_fits(jm, log, smi,
                                        synthobs.pop('uv1'))
        by_path['parallel'], par = run_parallel(
            jm, log, tmp, smi, rrl['core16'], em['scan_args'],
            cube.pop('clean8'))
        ex_launches, examples = run_examples(tmp, smi)
        # the pipeline is what a user runs: its counts stand for the two
        # kernels it launches
        launches.update({k: by_path['pipeline'][k] for k in PIPELINE_KERNELS})
        band, core16 = rrl['band'], rrl['core16']

        # continuum: the same card tensors through the plain versions
        jm.time = EPOCHS_YR[-1] * YEAR
        st = jm._rt_static()
        off = jm._ts_pack_offset
        t = jm.time
        pa, pe = kn.epoch_base_maps2_tiles_plain(st.a_t, st.em_t, st.tss_t,
                                                 st.seg, t, bursts, jm.nx,
                                                 jm.nz, off)
        want = products_from_maps(jm, st, pa, pe)
        got = jm.continuum_rt_products(FREQS, as_numpy=False)
        for name, g, w in zip(('em', 'tau', 'flux'), got, want):
            check(f"flagship {name} vs plain", g, w, MAP_RTOL)

        # each continuum kernel against its plain version at the main
        # path's shapes
        errs = {}
        g1 = [kn.epoch_base_map_tiles(x, st.tss_t, st.seg, t, bursts, jm.nx,
                                      jm.nz, off, walk=st.walk)
              for x in (st.a_t, st.em_t)]
        errs['epoch_base_map_tiles'] = max(check(
            f'epoch_base_map_tiles ({name}) at main-path shape', g,
            kn.epoch_base_map_tiles_plain(x, st.tss_t, st.seg, t, bursts,
                                          jm.nx, jm.nz, off), KERNEL_RTOL)
            for name, g, x in zip(('a', 'em'), g1, (st.a_t, st.em_t)))
        g2 = kn.epoch_base_maps2_tiles(st.a_t, st.em_t, st.tss_t, st.seg, t,
                                       bursts, jm.nx, jm.nz, off)
        if not all(torch.equal(g, h) for g, h in zip(g1, g2)):
            raise AssertionError("at the flagship, epoch_base_map_tiles of "
                                 "a base is not epoch_base_maps2_tiles' map "
                                 "of it bit for bit")
        print("  epoch_base_map_tiles of a and of em: bit for bit "
              "epoch_base_maps2_tiles' maps")
        errs['epoch_base_maps2_tiles'] = max(
            check('epoch_base_maps2_tiles (a) at main-path shape', g2[0],
                  pa, KERNEL_RTOL),
            check('epoch_base_maps2_tiles (em) at main-path shape', g2[1],
                  pe, KERNEL_RTOL))
        g3 = kn.epoch_base_map_full(st.a, st.ts_signed, t, bursts, off)
        w3 = kn.epoch_base_map_full_plain(st.a, st.ts_signed, t, bursts,
                                          off)
        errs['epoch_base_map_full'] = check(
            'epoch_base_map_full at main-path shape', g3, w3, KERNEL_RTOL)

        # RRL: the flagship's tau_L and flux through the plain versions
        jm.time = RRL_EPOCH_YR * YEAR
        _, tau_k, flux_k = jm.rrl_rt_products(RRL_LINE, band, contsub=False,
                                              as_numpy=False)
        (tau_p, flux_p, k4_in, walk) = rrl_products_plain(jm, band)
        check(f"flagship RRL tau_L ({RRL_NCHAN} ch) vs plain", tau_k, tau_p,
              MAP_RTOL)
        check(f"flagship RRL flux ({RRL_NCHAN} ch) vs plain", flux_k,
              flux_p, MAP_RTOL)
        del tau_k, flux_k, tau_p, flux_p
        # the tile kernel's maps against its plain version (per-tile
        # partials, then the fold); the partials are kept to time the fold
        parts_p, parts_ms = timed_once(
            lambda: kn.rrl_tile_partials_plain(*k4_in))
        seg = kn.tile_segments(*walk[:2])
        maps_p, fold_ms = timed_once(
            lambda: kn.segment_tile_maps(parts_p, seg, jm.nx, jm.nz))
        plain4_ms = parts_ms + fold_ms
        maps_k = kn.rrl_tiles(*k4_in, *walk)
        errs['rrl_tiles_pallas'] = check(
            f'rrl_tiles_pallas maps at main-path shape ({RRL_NCHAN} ch)',
            maps_k, maps_p, KERNEL_RTOL)
        del maps_k, maps_p
        # the cube kernel on the flagship's full-grid factors (real jet
        # cells), at 16 and at RRL_NCHAN channels
        k5_in16 = rrl_full_inputs(jm, core16)
        g5 = kn.rrl_cube(*k5_in16)
        w5 = kn.rrl_cube_plain(*k5_in16)
        check(f'rrl_cube_pallas, {N_GRID}^3 flagship factors, 16 ch', g5,
              w5, KERNEL_RTOL)
        del g5, w5
        k5_in = ((jm._freqs(band) - rrl['nu0']).to(torch.float32),
                 *k5_in16[1:])
        g5 = kn.rrl_cube(*k5_in)
        w5, plain5_ms = timed_once(lambda: kn.rrl_cube_plain(*k5_in))
        err5 = check(
            f'rrl_cube_pallas, {N_GRID}^3 flagship factors, {RRL_NCHAN} ch',
            g5, w5, KERNEL_RTOL)
        del g5, w5
        # ... and on the jet-free grid, the main path's case: exact zeros
        empty.time = jm.time
        k5_free = rrl_full_inputs(empty, band)
        g5 = kn.rrl_cube(*k5_free)
        w5, plain5_free_ms = timed_once(lambda: kn.rrl_cube_plain(*k5_free))
        errs['rrl_cube_pallas'] = max(err5, check(
            f'rrl_cube_pallas, {N_GRID}^3 jet-free grid, {RRL_NCHAN} ch', g5,
            w5, KERNEL_RTOL))
        if int(torch.count_nonzero(g5)) or int(torch.count_nonzero(w5)):
            raise AssertionError("the jet-free grid gave non-zero RRL maps")
        del g5, w5

        # emergent: the flagship's maps and each kernel against its plain
        # version, the two full-grid kernels against the tile kernel
        jm.time = EMERGENT_EPOCH_YR * YEAR
        errs.update(check_emergent(jm, em))
        scan_c = em['c']
        del em
        torch.cuda.empty_cache()

        # small models: float32 kernels against the float64 plain path
        small = []
        rrl_small = []
        for dt in (torch.float32, torch.float64):
            m = JetModel(example_params((64, 160, 64)), log=log, dtype=dt,
                         device='cuda')
            m.time = EPOCHS_YR[0] * YEAR
            small.append(m.continuum_rt_products(FREQS, as_numpy=False))
            small_band = np.concatenate([band[::50], core16])
            rrl_small.append(m.rrl_rt_products(RRL_LINE, small_band,
                                               contsub=False,
                                               as_numpy=False))
        for name, g, w in zip(('em', 'tau', 'flux'), *small):
            check(f"64x160x64 float32 {name} vs float64", g, w, MAP_RTOL)
        for name, g, w in zip(('em', 'tau_L', 'flux'), *rrl_small):
            check(f"64x160x64 float32 RRL {name} vs float64", g, w,
                  RRL_F32_RTOL)
        del small, rrl_small
        for inc, pa in ((90.0, 0.0), (55.0, 30.0)):
            maps = []
            for dt in (torch.float32, torch.float64):
                p = example_params((64, 160, 64))
                p['geometry'].update(inc=inc, pa=pa)
                m = JetModel(p, log=log, dtype=dt, device='cuda')
                m.time = EMERGENT_EPOCH_YR * YEAR
                maps.append(m._emergent_maps(FREQS))
            check(f"64x160x64 float32 emergent vs float64, inc {inc:g} pa "
                  f"{pa:g}", *maps, EMERGENT_F32_RTOL)
        del maps

        # ---------------- phase 3: numbers ---------------- #
        print("phase 3: numbers")
        n_act = st.a_t.shape[0]
        tile_bytes = st.a_t[0].numel() * 4
        print(f"  n_act = {n_act} of "
              f"{(N_GRID // 8) * (N_GRID // 64) * (N_GRID // 128)} tiles; "
              f"dual-base kernel reads {3 * n_act * tile_bytes} bytes "
              f"per epoch")
        print(f"  grid fill {cont['fill_cold_s']:.4f} s (first in the "
              f"process, kernel modules loading), {cont['fill_warm_s']:.4f} "
              f"s (second {N_GRID}^3 fill); continuum run "
              f"{cont['wall_s']:.4f} s (two fills, statics, all products); "
              f"peak memory {cont['peak_gb']:.3f} GB")
        print(f"  synthetic observations (phase 2e): execute "
              f"{synthobs['wall_s']:.4f} s for six continuum runs, Hogbom "
              f"{synthobs['it_s']:.1f} iterations per second, peak memory "
              f"{synthobs['peak_gb']:.3f} GB; card vs CPU: " + ', '.join(
                  f"{k} {v:.3e}" for k, v in synthobs['errs'].items()))
        print(f"  line-cube observation (phase 2f): execute "
              f"{cube['wall_s']:.4f} s for one {RRL_NCHAN}-channel RRL run, "
              f"channel block {cube['chan_block']}, batched Hogbom "
              f"{cube['it_s']:.1f} loop iterations and "
              f"{cube['chan_it_s']:.1f} "
              f"channel-iterations per second, peak memory "
              f"{cube['peak_gb']:.3f} GB; card vs CPU: " + ', '.join(
                  f"{k} {v:.3e}" for k, v in cube['errs'].items()))
        print(f"  diagnostics and analysis (phase 2g): " + ', '.join(
            f"{k} {v:.4f} ms" for k, v in ana['ms'].items()) +
            f"; peak memory {ana['peak_gb']:.3f} GB; {ANALYSIS_CPU_GRID}^3 "
            f"card vs CPU: " + ', '.join(
                f"{k} {v:.3e}" for k, v in ana['errs'].items()))
        print(f"  RRL run {rrl['wall_s']:.4f} s (tiles, LTE and non-LTE "
              f"{RRL_NCHAN}-channel products, 16-channel tau and flux, the "
              f"jet-free grid); peak memory {rrl['peak_gb']:.3f} GB")
        jm.time = EPOCHS_YR[-1] * YEAR
        epoch_ms = cuda_ms(lambda: jm.continuum_rt_products(
            FREQS, as_numpy=False))
        t0 = time.perf_counter()
        for _ in range(10):
            jm.continuum_rt_products(FREQS)
        host_ms = (time.perf_counter() - t0) / 10 * 1e3
        print(f"  continuum_rt_products warm: {epoch_ms:.4f} ms per epoch "
              f"(CUDA events, median of 30, device tensors out); "
              f"{host_ms:.4f} ms per epoch with the numpy copy-out (host "
              f"clock, mean of 10)")
        print_busy('continuum epochs', lambda: jm.continuum_rt_products(
            FREQS, as_numpy=False), 10)
        jm.time = RRL_EPOCH_YR * YEAR
        rrl_ms = cuda_ms(lambda: jm.rrl_rt_products(
            RRL_LINE, band, contsub=False, as_numpy=False), n_rep=10,
            n_warm=1)
        t0 = time.perf_counter()
        for _ in range(3):
            jm.rrl_rt_products(RRL_LINE, band, contsub=False)
        rrl_host_ms = (time.perf_counter() - t0) / 3 * 1e3
        print(f"  rrl_rt_products warm ({RRL_NCHAN} ch, LTE): {rrl_ms:.4f} "
              f"ms per run (CUDA events, median of 10, device tensors out); "
              f"{rrl_host_ms:.4f} ms per run with the numpy copy-out (host "
              f"clock, mean of 3)")
        print_busy(f'rrl_rt_products runs ({RRL_NCHAN} ch)',
                   lambda: jm.rrl_rt_products(RRL_LINE, band, contsub=False,
                                              as_numpy=False), 3)

        rows = []
        rows += epoch_tile_numbers(jm, bursts, smi)

        # RRL kernels: kernel, plain, kernel.  The tile kernel as the maps
        # call at 16 and RRL_NCHAN channels; the cube kernel on the
        # flagship's factors at both, and on the jet-free grid (its main
        # path's case, the row of the summary line)
        print_ptxas(kn.build_log(), r'rrl_\w+?_kernel',
                    {'rrl_tiles_kernel', 'rrl_activity_kernel',
                     'rrl_cube_kernel', 'rrl_flux_kernel'})
        k4_in16, _ = rrl_tile_inputs(jm, core16)
        maps4 = lambda *a: kn.rrl_tiles(*a, *walk)
        maps4_plain = lambda *a: kn.rrl_tiles_plain(*a, *walk)
        rrl_work = [
            ('rrl_tiles_pallas', 'maps', maps4, maps4_plain, k4_in16, None),
            ('rrl_tiles_pallas', 'maps', maps4, maps4_plain, k4_in,
             plain4_ms),
            ('rrl_cube_pallas', 'flagship factors', kn.rrl_cube,
             kn.rrl_cube_plain, k5_in16, None),
            ('rrl_cube_pallas', 'flagship factors', kn.rrl_cube,
             kn.rrl_cube_plain, k5_in, plain5_ms),
            ('rrl_cube_pallas', 'jet-free grid', kn.rrl_cube,
             kn.rrl_cube_plain, k5_free, plain5_free_ms),
        ]
        for name, what, kfn, pfn, args, plain_once in rrl_work:
            n_chan = args[0].numel()
            n_rep, batch = (10, 1) if n_chan == RRL_NCHAN else (30, 10)
            k1 = cuda_ms(lambda: kfn(*args), n_rep=n_rep, batch=batch,
                         n_warm=1)
            if plain_once is not None:
                p1, how = plain_once, 'one call'
            else:
                p1, how = cuda_ms(lambda: pfn(*args), n_rep=3,
                                  n_warm=1), 'median of 3'
            k2 = cuda_ms(lambda: kfn(*args), n_rep=n_rep, batch=batch,
                         n_warm=0)
            dev = kernel_ms(lambda: kfn(*args))
            n_b = rrl_bytes(args, (n_chan, jm.nx, jm.nz))
            n_ops, n_core, n_far = rrl_ops(*args[:5])
            b_ms, b_by = bound(n_b, n_ops)
            issue_ms = ((n_core + n_far) * RRL_ISSUE_COMMON +
                        n_core * RRL_ISSUE_CORE + n_far * RRL_ISSUE_FAR) / \
                PEAK_F32_ISSUE_PER_S * 1e3
            print(f"  {name} ({what}), {n_chan} ch: kernel {k1:.4f} / "
                  f"{k2:.4f} ms (median of {n_rep} batches of {batch}), "
                  f"device {dev:.4f} ms (profiler, mean of 10), plain "
                  f"{p1:.4f} ms ({how}); bound {b_ms:.4f} ms by {b_by} "
                  f"({n_b} B, "
                  f"{n_ops} ops: {n_core} core and {n_far} wing "
                  f"cell-channels), {b_ms / k1:.3f} of it; the source's "
                  f"contracted instructions at the issue peak "
                  f"{issue_ms:.4f} ms")
            if n_chan == RRL_NCHAN and what != 'flagship factors':
                rows.append((name, dev, p1, b_ms, b_by))
        # where K4's time goes at RRL_NCHAN channels: the same cells with
        # every channel in the wings, with every channel near the line
        # centre, and no cell at all (the maps' zero writes alone)
        order, seg_start = walk[:2]
        no_tiles = (order, torch.zeros_like(seg_start), jm.nx, jm.nz)
        splits = {'wings only': (torch.linspace(3e7, 8e7, RRL_NCHAN), walk),
                  'line centre': (torch.linspace(-2e5, 2e5, RRL_NCHAN),
                                  walk),
                  'no jet cell': (k4_in[0], no_tiles)}
        for what, (fo, w) in splits.items():
            args = (fo.to(k4_in[0]),) + tuple(k4_in[1:])
            n_core, n_far = rrl_ops(*args[:5])[1:] if w is walk else (0, 0)
            dev = kernel_ms(lambda: kn.rrl_tiles(*args, *w))
            print(f"  rrl_tiles_pallas, {RRL_NCHAN} ch, {what}: device "
                  f"{dev:.4f} ms (profiler, mean of 10; {n_core} core and "
                  f"{n_far} wing cell-channels)")
        fold = cuda_ms(lambda: kn.segment_tile_maps(parts_p, seg, jm.nx,
                                                    jm.nz), n_rep=10)
        print(f"  the fold rrl_tiles_pallas replaced, {RRL_NCHAN} ch: "
              f"segment_tile_maps of the {nbytes(parts_p)}-byte per-tile "
              f"partials {fold:.4f} ms (median of 10; zero-filled buffer, "
              f"index_add_, permute copy); plain partials {parts_ms:.4f} ms "
              f"(one call)")
        del parts_p

        rows += emergent_numbers(jm, scan_c)
        wofz_row, errs['wofz'] = wofz_numbers(smi)
        rows.append(wofz_row)
        # the fits are what launch the Faddeeva kernel
        launches['wofz'] = by_path['fit']['wofz']
        hogbom_row, errs['hogbom'] = hogbom_numbers(smi)
        rows.append(hogbom_row)
        # the observed cube's CLEAN launches the Hogbom kernels the most
        launches['hogbom'] = by_path['cube']['hogbom']
        full_rows, full_errs = full_grid_numbers(jm, empty, bursts)
        rows += full_rows
        for name, err in full_errs.items():
            errs[name] = max(errs[name], err)

        cli['solve'] = stefcal_numbers(cli_solve, smi)
        del cli_solve
        print(f"  the CLI (phase 2h): {cli['wall_s']:.4f} s for six runs "
              f"with corruption, two selfcal rounds and UVFITS export; a "
              f"StEFCal solve {cli['solve']['ops']:g} device operations, "
              f"{cli['solve']['ms']:.4f} ms; peak memory "
              f"{cli['peak_gb']:.3f} GB; card vs CPU: " + ', '.join(
                  f"{k} {v:.3e}" for k, v in cli['errs'].items()))
        print(f"  script time before the summary "
              f"{time.perf_counter() - t_script:.1f} s")
        print(smi)
        out = []
        for name, k_ms, p_ms, b_ms, b_by in rows:
            rel, abs_err = errs[name]
            source, replaces = KERNELS[name]
            out.append({'name': name, 'route': 'cuda', 'source': source,
                        'replaces': replaces, 'launches': launches[name],
                        'launches_by_path': {
                            **{p: c[name] for p, c in by_path.items()},
                            'examples': {ex: c[name] for ex, c in
                                         ex_launches.items()}},
                        'max_abs_err': abs_err, 'max_rel_err': rel,
                        'ms': k_ms, 'plain_ms': p_ms, 'bound_ms': b_ms,
                        'bound_by': b_by, 'library_ms': None})
        print(json.dumps({'kernels': out, 'cube_observation': {
            k: cube[k] for k in ('wall_s', 'peak_gb', 'chan_block',
                                 'iterations', 'loop_iterations',
                                 'channel_iterations', 'it_s', 'chan_it_s',
                                 'stages_ms')},
            'analysis': {k: ana[k] for k in ('ms', 'peak_gb', 'errs')},
            'cli': cli, 'fit': fits, 'parallel': par,
            'examples': examples}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def time_paths(root) -> int:
    """``python3 chip_smoke.py --time-paths DIR``: the flagship's calls
    timed with the package of the checkout DIR (this one, or an unpacked
    parent commit, so that two commits are compared on one card, in
    turns): warm ``continuum_rt_products`` (16 channels),
    ``_emergent_maps`` (16 channels), ``_continuum_product('flux')`` (16
    channels, the map of ``flux_ff``), ``_epoch_base_map('em')`` (the map
    of ``emission_measure``) and ``rrl_rt_products`` (1,000 channels, LTE)
    by CUDA events; device busy time and device operations per call of all
    but the last and of the dual-base epoch kernel's call; the emergent
    tile kernel's device time.  Prints one JSON line.  Checks nothing: the
    main run of this script does."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(root))
    from rajepy_tpu_torch import JetModel
    from rajepy_tpu_torch.ops import kernels as kn
    from rajepy_tpu_torch.ops import radtrans as rt
    jm = JetModel(example_params((N_GRID,) * 3), dtype='auto', device='cuda')
    jm.time = EMERGENT_EPOCH_YR * YEAR
    nu0 = rt.RRLCoeffs(RRL_LINE).nu0
    band = rrl_band(nu0)[0]
    st = jm._rt_static()
    bursts, off = jm._burst_tuple(), jm._ts_pack_offset
    walk = {'walk': st.walk} if hasattr(st, 'walk') else {}
    f = jm._ensure_fields()
    calls = {
        'epoch': lambda: jm.continuum_rt_products(FREQS, as_numpy=False),
        'emergent': lambda: jm._emergent_maps(FREQS),
        'flux_ff': lambda: jm._continuum_product('flux', FREQS),
        'em_map': lambda: jm._epoch_base_map('em', f, st, jm.time),
        'k2_call': lambda: kn.epoch_base_maps2_tiles(
            st.a_t, st.em_t, st.tss_t, st.seg, jm.time, bursts, jm.nx, jm.nz,
            off, **walk)}
    timed = ('epoch', 'emergent', 'flux_ff', 'em_map')
    out = {'root': os.path.abspath(root),
           'device': torch.cuda.get_device_name(0)}
    for name in timed:
        out[f'{name}_ms'] = cuda_ms(calls[name])
    out['rrl_ms'] = cuda_ms(lambda: jm.rrl_rt_products(
        RRL_LINE, band, contsub=False, as_numpy=False), n_rep=10, n_warm=1)
    for name, fn in calls.items():
        busy_ms, _, n_ops, _ = device_busy(fn)
        out[f'{name}_busy_ms'], out[f'{name}_ops'] = busy_ms, n_ops
    k6, _, _ = emergent_tile_args(jm)
    out['emergent_ff_tiles_ms'] = kernel_ms(
        lambda: kn.emergent_tile_partials(*k6))
    for name in timed:
        out[f'{name}_ms_again'] = cuda_ms(calls[name])
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    if len(sys.argv) == 3 and sys.argv[1] == '--time-paths':
        sys.exit(time_paths(sys.argv[2]))
    sys.exit(main())
