// The verify's tile instances with the query rows padded to 16 (the
// reference's g_pad_min 8): see splitmax_verify_tiles.cuh.
#define SPLITMAX_VERIFY_ROW_PAD 16
#define SPLITMAX_VERIFY_TILES_ERROR_FN splitmax_verify_tiles_error_string
#include "splitmax_verify_tiles.cuh"
