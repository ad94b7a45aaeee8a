// K2 (megastep.cu) with a cut after each of its phases, built by
// tools/megastep_phases.py: tds_megastep_set_stop(k) makes the kernel return
// after its k-th PHASE_END, and k = 0 runs it whole.
#define MEGASTEP_PHASE_CUTS
#include "megastep.cu"
