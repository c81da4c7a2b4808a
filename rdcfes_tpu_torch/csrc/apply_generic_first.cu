// K6 apply_generic's instances of HEX8 (8, 8), PRISM6 (6, 8),
// PYRAMID5 (5, 8) and TET10 (10, 14), in both types and
// at 1-8 species (the kernel: apply_generic.cuh).
#include "apply_generic.cuh"

namespace rdc_generic {

RDC_GENERIC_DEFINE(8, 8)
RDC_GENERIC_DEFINE(6, 8)
RDC_GENERIC_DEFINE(5, 8)
RDC_GENERIC_DEFINE(10, 14)

}  // namespace rdc_generic
