// K6 apply_generic's instances of QUAD4 (4, 4), QUAD8
// (8, 9) and QUAD9 (9, 9), in both types and
// at 1-8 species (the kernel: apply_generic.cuh).
#include "apply_generic.cuh"

namespace rdc_generic {

RDC_GENERIC_DEFINE(4, 4)
RDC_GENERIC_DEFINE(8, 9)
RDC_GENERIC_DEFINE(9, 9)

}  // namespace rdc_generic
