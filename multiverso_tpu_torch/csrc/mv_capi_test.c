/* mv_capi_test: end-to-end C driver over the full MV_* ABI of
 * multiverso_tpu_torch (csrc/mv_capi.cpp).
 *
 * The reference ships a runnable binding test (ref: binding/lua/test.lua
 * :1-79, array and matrix round trips through the C API); this driver
 * covers the same surface from plain C, with assertions, including the
 * async row ops and the async-plane tables. Built and run by
 * multiverso_tpu_torch/native/capi.py (build_driver, driver_env) and
 * tests/test_torch_capi.py.
 *
 * Needs PYTHONPATH to reach multiverso_tpu_torch and torch. The tables
 * live on the card; MV_CAPI_PLATFORM=cpu puts them on the CPU.
 */

#include <math.h>
#include <stdio.h>
#include <stdlib.h>

typedef void* TableHandler;

/* the ABI under test (mirrors ref include/multiverso/c_api.h:16-54) */
/* BEGIN generated ABI declarations (multiverso_tpu_torch/tools/gen_capi_surface.py) */
void MV_Init(int* argc, char** argv);
void MV_ShutDown(void);
void MV_Barrier(void);
int  MV_NumWorkers(void);
int  MV_WorkerId(void);
int  MV_ServerId(void);
void MV_NewArrayTable(int size, TableHandler* out);
void MV_GetArrayTable(TableHandler handler, float* data, int size);
void MV_AddArrayTable(TableHandler handler, float* data, int size);
void MV_AddAsyncArrayTable(TableHandler handler, float* data, int size);
void MV_NewAsyncArrayTable(int size, TableHandler* out);
void MV_NewAsyncMatrixTable(int num_row, int num_col, TableHandler* out);
void MV_NewMatrixTable(int num_row, int num_col, TableHandler* out);
void MV_GetMatrixTableAll(TableHandler handler, float* data, int size);
void MV_AddMatrixTableAll(TableHandler handler, float* data, int size);
void MV_AddAsyncMatrixTableAll(TableHandler handler, float* data, int size);
void MV_GetMatrixTableByRows(TableHandler handler, float* data, int size, int row_ids[], int row_ids_n);
void MV_AddMatrixTableByRows(TableHandler handler, float* data, int size, int row_ids[], int row_ids_n);
void MV_AddAsyncMatrixTableByRows(TableHandler handler, float* data, int size, int row_ids[], int row_ids_n);
/* END generated ABI declarations */

static int g_failures = 0;

static void expect(int cond, const char* what) {
  if (!cond) {
    fprintf(stderr, "FAIL: %s\n", what);
    g_failures++;
  }
}

static void expect_near(float got, float want, const char* what) {
  if (fabsf(got - want) > 1e-4f) {
    fprintf(stderr, "FAIL: %s (got %f want %f)\n", what, got, want);
    g_failures++;
  }
}

int main(void) {
  MV_Init(NULL, NULL);
  expect(MV_NumWorkers() >= 1, "MV_NumWorkers >= 1");
  expect(MV_WorkerId() >= 0, "MV_WorkerId >= 0");
  expect(MV_ServerId() >= 0, "MV_ServerId >= 0");
  MV_Barrier();

  /* ---- array table: sync + async adds, read-back ---- */
  enum { N = 16 };
  TableHandler at = NULL;
  MV_NewArrayTable(N, &at);
  expect(at != NULL, "MV_NewArrayTable handle");
  float delta[N], out[N];
  for (int i = 0; i < N; i++) delta[i] = (float)i;
  MV_AddArrayTable(at, delta, N);
  MV_AddAsyncArrayTable(at, delta, N);
  MV_Barrier(); /* fences the async add (ref test.lua barrier) */
  MV_GetArrayTable(at, out, N);
  for (int i = 0; i < N; i++) expect_near(out[i], 2.0f * i, "array sum");

  /* ---- matrix table: whole-table + row ops, sync + async ---- */
  enum { R = 8, C = 4, SZ = R * C };
  TableHandler mt = NULL;
  MV_NewMatrixTable(R, C, &mt);
  expect(mt != NULL, "MV_NewMatrixTable handle");
  float md[SZ], mo[SZ];
  for (int i = 0; i < SZ; i++) md[i] = 1.0f;
  MV_AddMatrixTableAll(mt, md, SZ);
  MV_AddAsyncMatrixTableAll(mt, md, SZ);
  MV_Barrier();
  MV_GetMatrixTableAll(mt, mo, SZ);
  for (int i = 0; i < SZ; i++) expect_near(mo[i], 2.0f, "matrix all sum");

  int rows[2] = {1, 6};
  float rvals[2 * C], rout[2 * C];
  for (int i = 0; i < 2 * C; i++) rvals[i] = 0.5f;
  MV_AddMatrixTableByRows(mt, rvals, 2 * C, rows, 2);
  MV_AddAsyncMatrixTableByRows(mt, rvals, 2 * C, rows, 2);
  MV_Barrier();
  MV_GetMatrixTableByRows(mt, rout, 2 * C, rows, 2);
  for (int i = 0; i < 2 * C; i++)
    expect_near(rout[i], 3.0f, "matrix row sum"); /* 2 + 0.5 + 0.5 */
  /* untouched row keeps the whole-table value */
  int row0[1] = {0};
  float r0[C];
  MV_GetMatrixTableByRows(mt, r0, C, row0, 1);
  for (int i = 0; i < C; i++) expect_near(r0[i], 2.0f, "untouched row");

  /* ---- async-plane tables (beyond the reference C API): the same
   * accessors, uncoordinated ownership; MV_Barrier flushes this
   * process's outstanding async ops before fencing. ---- */
  TableHandler aat = NULL;
  MV_NewAsyncArrayTable(N, &aat);
  expect(aat != NULL, "MV_NewAsyncArrayTable handle");
  MV_AddArrayTable(aat, delta, N);
  MV_AddAsyncArrayTable(aat, delta, N);
  MV_Barrier();
  MV_GetArrayTable(aat, out, N);
  for (int i = 0; i < N; i++)
    expect_near(out[i], 2.0f * i, "async array sum");

  TableHandler amt = NULL;
  MV_NewAsyncMatrixTable(R, C, &amt);
  expect(amt != NULL, "MV_NewAsyncMatrixTable handle");
  MV_AddMatrixTableAll(amt, md, SZ);
  MV_AddAsyncMatrixTableAll(amt, md, SZ);
  MV_Barrier();
  MV_GetMatrixTableAll(amt, mo, SZ);
  for (int i = 0; i < SZ; i++)
    expect_near(mo[i], 2.0f, "async matrix all sum");
  MV_AddMatrixTableByRows(amt, rvals, 2 * C, rows, 2);
  MV_AddAsyncMatrixTableByRows(amt, rvals, 2 * C, rows, 2);
  MV_Barrier();
  MV_GetMatrixTableByRows(amt, rout, 2 * C, rows, 2);
  for (int i = 0; i < 2 * C; i++)
    expect_near(rout[i], 3.0f, "async matrix row sum");

  MV_ShutDown();
  if (g_failures == 0) {
    printf("MV_CAPI_TEST PASS\n");
    return 0;
  }
  fprintf(stderr, "MV_CAPI_TEST: %d failures\n", g_failures);
  return 1;
}
