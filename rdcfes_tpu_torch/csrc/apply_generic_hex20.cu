// K6 apply_generic's instances of HEX20 (20, 27), in both types and
// at 1-8 species (the kernel: apply_generic.cuh).
#include "apply_generic.cuh"

namespace rdc_generic {

RDC_GENERIC_DEFINE(20, 27)

}  // namespace rdc_generic
