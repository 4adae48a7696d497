// The verify's tile instances with the query rows padded to 32 (the
// reference's g_pad_min 16), the paged verify's among them: see
// splitmax_verify_tiles.cuh.
#define SPLITMAX_VERIFY_ROW_PAD 32
#define SPLITMAX_VERIFY_TILES_ERROR_FN splitmax_verify_tiles_pad_error_string
#include "splitmax_verify_tiles.cuh"
